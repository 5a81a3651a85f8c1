"""PyTorch/CUDA port of ``repro`` (asynchronous multistage checkpointing).

Mirrors the JAX package's layout (``core``, ``api``, ``models``,
``configs``, ``kernels``, ``optim``); the JAX package stays the reference
every part is held against.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

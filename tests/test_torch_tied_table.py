"""A tied table's two gradients in one buffer (``layers.embed(tied=True)``
with ``layers.head_table``): the gather's rows are added into the loss
head's dense gradient in place, bit for bit the gradient autograd's sum of
the two dense gradients gives."""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.models import layers as L

V, D, B, S = 300, 16, 2, 24


def _case(seed):
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.standard_normal((V, D)).astype(np.float32))
    tokens = torch.tensor(rng.integers(0, V, (B, S + 1)), dtype=torch.int32)
    tokens[0, :6] = 7          # a token read many times
    return table, tokens


def _loss(table, tokens, tied, detach=False):
    h = L.embed({"emb": table}, tokens[:, :-1], L.DTypes(), tied=tied)
    if detach:
        h = h.detach()
    h = torch.tanh(h.float()).to(torch.bfloat16) * 1.5
    return L.chunked_ce_loss(h, table, tokens[:, 1:], chunk=8,
                             logit_cap=30.0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("how", ["grad", "backward"])
def test_tied_gradient_bit_for_bit_and_in_place(seed, how, monkeypatch):
    table, tokens = _case(seed)
    w = table.clone().requires_grad_(True)
    want = torch.autograd.grad(_loss(w, tokens, tied=False), [w])[0]
    stashed = []
    cast_bwd = L._HeadCast.backward

    def spy(ctx, g):
        tie = ctx.tie
        out = cast_bwd(ctx, g)
        # its address only: a reference would make autograd copy it
        stashed.append(None if tie.grad is None else tie.grad.data_ptr())
        return out

    monkeypatch.setattr(L._HeadCast, "backward", staticmethod(spy))
    w = table.clone().requires_grad_(True)
    loss = _loss(w, tokens, tied=True)
    if how == "grad":
        got = torch.autograd.grad(loss, [w])[0]
    else:
        loss.backward()
        got = w.grad
    assert torch.equal(got, want)
    # the head left its gradient to the gather, which returned that buffer
    assert len(stashed) == 1 and stashed[0] is not None
    assert got.data_ptr() == stashed[0]
    assert len(L._TIES) == 0


def test_tied_gradient_without_the_gather():
    """The gather's node is not in the backward pass (its rows detached):
    the head keeps its own gradient."""
    table, tokens = _case(2)
    w = table.clone().requires_grad_(True)
    got = torch.autograd.grad(_loss(w, tokens, tied=True, detach=True),
                              [w])[0]
    w2 = table.clone().requires_grad_(True)
    want = torch.autograd.grad(_loss(w2, tokens, tied=False, detach=True),
                               [w2])[0]
    assert torch.equal(got, want)


def test_untied_or_no_grad_leaves_no_tie():
    table, tokens = _case(3)
    with torch.no_grad():
        L.embed({"emb": table.requires_grad_(True)}, tokens, tied=True)
    L.embed({"emb": table.detach()}, tokens, tied=True)
    assert len(L._TIES) == 0


def test_tie_does_not_outlive_its_graph():
    """No reference cycle through the gather's node: a forward whose graph
    is dropped leaves no tie alive."""
    def forward_only():
        table, tokens = _case(4)
        w = table.requires_grad_(True)
        L.embed({"emb": w}, tokens, tied=True)
        return weakref.ref(L._TIES[w])

    refs = [forward_only() for _ in range(3)]
    gc.collect()
    assert all(r() is None for r in refs)


def test_tied_gradient_twice_through_a_retained_graph():
    table, tokens = _case(5)
    w = table.clone().requires_grad_(True)
    want = torch.autograd.grad(_loss(w, tokens, tied=False), [w])[0]
    w = table.clone().requires_grad_(True)
    loss = _loss(w, tokens, tied=True)
    first = torch.autograd.grad(loss, [w], retain_graph=True)[0]
    second = torch.autograd.grad(loss, [w])[0]
    assert torch.equal(first, want) and torch.equal(second, want)

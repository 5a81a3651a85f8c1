"""Models (ported subset: the paper's §5 LSTM)."""

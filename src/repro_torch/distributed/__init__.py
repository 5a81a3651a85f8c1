"""Host-side codecs (ported subset: the int8 codec Level 2 uses)."""

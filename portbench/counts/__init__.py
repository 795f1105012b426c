"""Operations and bytes worked out from shapes: the yardstick of the
roofline and MFU metrics. One file per count; a configuration names its
model's file under ``counts`` in its JSON."""

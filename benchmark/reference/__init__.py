"""The plain PyTorch reference of AVSyncD that decides `correct`: float32
with TF32 off, or the float8 control (ops.py).  It imports nothing of the
system under test and takes none of its weights, tables or states."""

"""checkpoint: the reference's on-disk checkpoint layout, read and written
with numpy (see checkpointer.py)."""

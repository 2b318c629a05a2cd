"""Checkpointing in the reference's on-disk format (:mod:`.checkpointer`)."""
from .checkpointer import CheckpointCorrupt, Checkpointer  # noqa: F401

"""Framework helpers over the DDSes (undo-redo)."""

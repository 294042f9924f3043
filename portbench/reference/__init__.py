"""Plain float32 references in PyTorch (no TF32), independent of the
program under test."""

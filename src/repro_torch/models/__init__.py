"""Model primitives, blocks and LM assembly on torch tensors."""

"""Training-side helpers of the port (so far: magnitude pruning masks)."""

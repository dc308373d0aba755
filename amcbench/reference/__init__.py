"""The plain PyTorch reference the served logits are held to."""

"""Model configurations of the port: so far the paper's own SNN (the LM
model zoo is not ported yet)."""

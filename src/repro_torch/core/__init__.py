"""Core numerics of the port: sparse formats, LIF, Σ-Δ, GOAP, pooling."""

"""Input stage of the port: the batched Σ-Δ encoders."""

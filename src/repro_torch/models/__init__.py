"""The paper's SNN and its layer graph with pluggable backends."""

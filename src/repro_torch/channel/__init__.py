"""RF channel of the port: so far only the dataset generator's legacy
host-side channel; the scenario channels wait for the channel step."""

from .impairments import legacy_awgn_channel

__all__ = ["legacy_awgn_channel"]

"""Wireless channel, cell topology and the resource ledger (numpy)."""
from repro_torch.channels.fading import ChannelModel, ChannelParams
from repro_torch.channels.resources import (ResourceLedger, outage_probability,
                                            required_bandwidth,
                                            spectral_efficiency)
from repro_torch.channels.topology import CellTopology

__all__ = ["ChannelModel", "ChannelParams", "ResourceLedger",
           "required_bandwidth", "outage_probability", "spectral_efficiency",
           "CellTopology"]

"""Wireless channel, cell topology, the resource ledger and the evolving
wireless world."""
from repro_torch.channels.fading import ChannelModel, ChannelParams
from repro_torch.channels.resources import (ResourceLedger, outage_probability,
                                            required_bandwidth,
                                            spectral_efficiency)
from repro_torch.channels.topology import CellTopology
from repro_torch.channels.world import (SCENARIOS, HostWorld, WorldConfig,
                                        WorldState, init_world, step)

__all__ = ["ChannelModel", "ChannelParams", "ResourceLedger",
           "required_bandwidth", "outage_probability", "spectral_efficiency",
           "CellTopology", "SCENARIOS", "HostWorld", "WorldConfig",
           "WorldState", "init_world", "step"]

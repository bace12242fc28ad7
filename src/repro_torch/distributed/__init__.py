"""Client-stacked data plane: the LM fleet's vmapped train step, FedDif's
diffusion step, the Eq.-11 aggregation, diffusion and STC hops."""
from repro_torch.distributed.fedshard import (diffuse_params,
                                              fleet_aggregate,
                                              make_diffusion_step,
                                              make_fleet_train_step,
                                              masked_stc_compress)

__all__ = ["make_fleet_train_step", "make_diffusion_step", "fleet_aggregate",
           "diffuse_params", "masked_stc_compress"]

"""FedDif's control plane: DoL state, auction, planner and the schedule IR."""
from repro_torch.core.aggregation import model_bits
from repro_torch.core.auction import (AuctionConfig, AuctionResult,
                                      compute_bids, fuse_learning_value,
                                      run_auction)
from repro_torch.core.diffusion import (PLANNER_MODES, DiffusionHop,
                                        DiffusionPlan, DiffusionPlanner)
from repro_torch.core.dol import (DiffusionState, PlannerState, iid_distance,
                                  iid_distance_candidates, update_dol)
from repro_torch.core.matching import (auction_assign, hungarian_min_cost,
                                       max_weight_matching)
from repro_torch.core.schedule import (PermuteOp, RoundSchedule, TrainOp,
                                       WireEvent, charge_schedule,
                                       complete_round_permutation)

__all__ = ["model_bits", "AuctionConfig", "AuctionResult", "compute_bids",
           "fuse_learning_value", "run_auction", "PLANNER_MODES",
           "DiffusionHop", "DiffusionPlan", "DiffusionPlanner",
           "DiffusionState", "PlannerState", "iid_distance",
           "iid_distance_candidates", "update_dol", "auction_assign",
           "hungarian_min_cost", "max_weight_matching",
           "PermuteOp", "RoundSchedule", "TrainOp", "WireEvent",
           "charge_schedule", "complete_round_permutation"]

"""FedDif's control plane: DoL state, auction, planner and the schedule IR."""
from repro_torch.core.aggregation import (divergence_bound, fedavg,
                                          model_bits, weight_distance)
from repro_torch.core.auction import (AuctionConfig, AuctionResult,
                                      compute_bids, fuse_learning_value,
                                      run_auction)
from repro_torch.core.diffusion import (PLANNER_MODES, DiffusionHop,
                                        DiffusionPlan, DiffusionPlanner,
                                        PlanCache, feddif_cache_key,
                                        plan_cache_key)
from repro_torch.core.dol import (DiffusionState, PlannerState,
                                  closed_form_iid_distance, dsi_from_counts,
                                  entropy, iid_distance,
                                  iid_distance_candidates,
                                  min_feasible_data_size, optimal_dsi,
                                  uniform_dol, update_dol)
from repro_torch.core.matching import (auction_assign, auction_matching,
                                       hungarian_min_cost,
                                       max_weight_matching)
from repro_torch.core.schedule import (MixOp, PermuteOp, RoundSchedule,
                                       TrainOp, WireEvent, apply_churn,
                                       charge_schedule,
                                       complete_round_permutation)

__all__ = ["model_bits", "fedavg", "weight_distance", "divergence_bound",
           "AuctionConfig", "AuctionResult", "compute_bids",
           "fuse_learning_value", "run_auction", "PLANNER_MODES",
           "DiffusionHop", "DiffusionPlan", "DiffusionPlanner", "PlanCache",
           "plan_cache_key", "feddif_cache_key",
           "DiffusionState", "PlannerState", "iid_distance",
           "iid_distance_candidates", "update_dol", "uniform_dol",
           "dsi_from_counts", "optimal_dsi", "min_feasible_data_size",
           "closed_form_iid_distance", "entropy", "auction_assign",
           "auction_matching", "hungarian_min_cost", "max_weight_matching",
           "MixOp", "PermuteOp", "RoundSchedule", "TrainOp", "WireEvent",
           "apply_churn", "charge_schedule", "complete_round_permutation"]

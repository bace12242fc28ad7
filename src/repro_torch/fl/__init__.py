"""The FL runtime of the port: models, schedulers, fleet executor, server."""
from repro_torch.fl.experiment import (ExperimentSpec, load_experiment_data,
                                       run_experiment)
from repro_torch.fl.models import (TASK_MODELS, TaskModel, build_task_model,
                                   params_from_numpy, params_to_numpy)
from repro_torch.fl.server import STRATEGIES, FLConfig, RunResult, run_federated

__all__ = ["ExperimentSpec", "load_experiment_data", "run_experiment",
           "TASK_MODELS", "TaskModel", "build_task_model", "params_from_numpy",
           "params_to_numpy", "STRATEGIES", "FLConfig", "RunResult",
           "run_federated"]

"""The FL runtime of the port: models, adapter views, schedulers, fleet
executor, server."""
from repro_torch.fl.adapters import (AdapterView, make_adapter_view,
                                     packed_bits)
from repro_torch.fl.experiment import (ExperimentSpec, load_experiment_data,
                                       run_experiment, spec_adapter_bits,
                                       spec_model_bits)
from repro_torch.fl.models import (TASK_MODELS, TaskModel, build_task_model,
                                   params_from_numpy, params_to_numpy)
from repro_torch.fl.server import STRATEGIES, FLConfig, RunResult, run_federated

__all__ = ["ExperimentSpec", "load_experiment_data", "run_experiment",
           "spec_model_bits", "spec_adapter_bits", "AdapterView",
           "make_adapter_view", "packed_bits", "TASK_MODELS", "TaskModel",
           "build_task_model", "params_from_numpy", "params_to_numpy",
           "STRATEGIES", "FLConfig", "RunResult", "run_federated"]

"""The FL runtime of the port: models, adapter views, schedulers, the host
and fleet executors, the engine selection, server, round checkpoints and
experiment harness."""
from repro_torch.fl.adapters import (AdapterView, make_adapter_view,
                                     packed_bits)
from repro_torch.fl.client import make_local_update
from repro_torch.fl.compression import (compressed_bits, stc_compress,
                                        stc_compress_leaf)
from repro_torch.fl.engine import (ENGINE_PRESETS, EngineSpec, RunHistory,
                                   RunResult, engine_fingerprint,
                                   resolve_engine)
from repro_torch.fl.executors import (EXECUTORS, FleetExecutor, HostExecutor,
                                      make_executor)
from repro_torch.fl.experiment import (ExperimentSpec, load_experiment_data,
                                       run_experiment, spec_adapter_bits,
                                       spec_model_bits)
from repro_torch.fl.fedprox import make_prox_local_update
from repro_torch.fl.models import (TASK_MODELS, TaskModel, build_task_model,
                                   params_from_numpy, params_to_numpy)
from repro_torch.fl.resume import Preempted, RoundCheckpointer, RoundState
from repro_torch.fl.server import STRATEGIES, FLConfig, run_federated

__all__ = ["ExperimentSpec", "load_experiment_data", "run_experiment",
           "spec_model_bits", "spec_adapter_bits", "AdapterView",
           "make_adapter_view", "packed_bits", "make_local_update",
           "make_prox_local_update", "stc_compress",
           "stc_compress_leaf", "compressed_bits", "EngineSpec",
           "ENGINE_PRESETS", "resolve_engine", "engine_fingerprint",
           "RoundCheckpointer", "RoundState", "Preempted",
           "RunHistory", "RunResult", "HostExecutor", "FleetExecutor",
           "make_executor", "EXECUTORS", "TASK_MODELS", "TaskModel",
           "build_task_model", "params_from_numpy", "params_to_numpy",
           "STRATEGIES", "FLConfig", "run_federated"]

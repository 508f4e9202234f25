"""Data utilities of the port: the byte tokenizer, the benchmark workloads
and the calibrated pool simulator."""
from repro_torch.data.simulator import POOL_SPECS, SimulatedModel, make_simulated_pool  # noqa: F401
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
from repro_torch.data.workload import BENCHMARKS, Workload, make_workload  # noqa: F401

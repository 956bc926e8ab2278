"""The paper's own alignment workload (``wfa_paper``)."""
from repro_torch.configs.wfa_paper import CONFIG as wfa_paper  # noqa: F401

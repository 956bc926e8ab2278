"""The paper's own workload as a config: batched WFA alignment of
100bp read pairs at E in {2%, 4%} (Fig. 1 regime), distributed PIM-style
(pair axis over every mesh axis, no collectives)."""
import dataclasses

from repro_torch.core.penalties import Penalties


@dataclasses.dataclass(frozen=True)
class WFAWorkload:
    name: str = "wfa-paper"
    family: str = "alignment"
    read_len: int = 100
    edit_frac: float = 0.02          # paper E=2% (Fig. 1 also runs 4%)
    pairs_per_device: int = 2048     # one "MRAM load" per device per wave
    pen: Penalties = Penalties(x=4, o=6, e=2)
    block_pairs: int = 8             # kernel grid block ("DPU" granularity)


CONFIG = WFAWorkload()

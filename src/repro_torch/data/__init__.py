from repro_torch.data.reads import (ReadPairSpec, SampledRead,  # noqa: F401
                                    generate_pairs, generate_shard,
                                    sample_from_reference)
from repro_torch.data.io import (iter_seqs, load_pair_files,  # noqa: F401
                                 read_seqs)
from repro_torch.data.dna import (NCODE, as_ascii, decode_2bit,  # noqa: F401
                                  encode_2bit, random_reference, revcomp)

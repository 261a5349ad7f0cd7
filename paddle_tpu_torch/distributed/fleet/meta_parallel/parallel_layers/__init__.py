from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .pp_layers import (LayerDesc, PipelineLayer,  # noqa: F401
                        SegmentLayers, SharedLayerDesc)
from .random import (MODEL_PARALLEL_RNG, RNGStatesTracker,  # noqa: F401
                     get_rng_state_tracker, model_parallel_random_seed)

"""Model-parallel RNG seeding (counterpart of the reference's
``parallel_layers/random.py``; Paddle's fleet/meta_parallel/
parallel_layers/random.py): a local seed per rank, so dropout inside a
model-parallel region differs across the model ranks, and one global
seed alike on every rank."""

from __future__ import annotations

from .....core import flags
from .....core import rng as core_rng
from .....core.rng import RNGSequenceTracker

MODEL_PARALLEL_RNG = "model_parallel_rng"

RNGStatesTracker = RNGSequenceTracker


def get_rng_state_tracker() -> RNGSequenceTracker:
    return core_rng.get_rng_state_tracker()


def model_parallel_random_seed(seed: int = None):
    """Seed the tracker's ``model_parallel_rng`` stream with ``seed + 1024
    + rank`` and the global streams with ``seed``.  ``seed=None`` takes
    ``FLAGS_seed``, so every rank derives the same global seed."""
    from .... import env
    rank = env.get_rank()
    if seed is None:
        seed = int(flags.flag("FLAGS_seed"))
    tracker = get_rng_state_tracker()
    tracker.seeds.pop(MODEL_PARALLEL_RNG, None)
    tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + rank)
    core_rng.seed(seed)

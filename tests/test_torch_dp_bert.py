"""Port parity for BERT's data-parallel steps against the JAX package:
``make_bert_train_step`` over dp 2, where the two ranks see different
numbers of valid MLM labels and the loss is still the reference's
weighted mean over the whole batch, and ``make_sharded_bert_train_step``
with ZeRO-1 specs over sharding 2 (the reference's initial weights copied
into the port's state).  The ranks and the JAX arms are
``test_torch_dp.py``'s (one spawn of 2 ranks for this file); tolerances
as there: losses rtol 1e-5, atol 1e-6, parameters rtol 1e-4, atol 1e-5,
slots rtol 1e-5, atol 1e-6.
"""

import gc
import numpy as np
import pytest

from test_torch_dp import (BERT_ARMS, _bert_batch, _close, _compare,
                           _finish, _jax_bert, _jax_init, _jax_sharded_bert,
                           _start)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop the JAX arrays of this module and of ``test_torch_dp``'s
    cached reference runs when it ends (a later module in the same
    process ranks the live JAX arrays: the reference's memory
    forensics)."""
    yield
    from test_torch_dp import _jax_gpt, _jax_sharded_gpt
    _jax_gpt.cache_clear()
    _jax_sharded_gpt.cache_clear()
    gc.collect()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    init = _jax_init(("bert", "bert_sharded"))
    return _start(2, tmp_path_factory.mktemp("bert2"), init, BERT_ARMS)


@pytest.fixture(scope="module")
def ranks2(started):
    return _finish(started)


class TestBERT:
    def test_dp2_global_weighted_mlm_mean(self, started, ranks2):
        """The two ranks see different numbers of valid MLM labels; the
        loss is still the reference's weighted mean over the batch."""
        ids, mlm, nsp = _bert_batch()
        half = (mlm >= 0).reshape(2, -1).sum(1)
        assert half[0] != half[1]
        losses, jstate = _jax_bert(2)
        for rk in ranks2:
            _close(rk["bert_dp2"]["losses"], losses)
        _compare([rk["bert_dp2"]["state"] for rk in ranks2], jstate,
                 ("params", "opt"))

    def test_zero1_sharded_init(self, started, ranks2):
        losses, jstate = _jax_sharded_bert()
        for rk in ranks2:
            _close(rk["bert_z1"]["losses"], losses)
        _compare([rk["bert_z1"]["state"] for rk in ranks2], jstate,
                 ("params", "opt"))
        # ZeRO-1: each rank holds half of every divisible slot
        m1 = ranks2[0]["bert_z1"]["state"]["opt"]["slots"]
        w = ranks2[0]["bert_z1"]["state"]["params"]["blocks_fc1_w"]
        assert m1["blocks_fc1_w"]["moment1"].size == w.size // 2
        assert np.isfinite(losses).all()

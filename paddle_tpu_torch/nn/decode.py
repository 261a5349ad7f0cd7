"""Seq2seq decoding (counterpart of ``paddle_tpu/nn/decode.py``):
``BeamSearchDecoder`` over an RNN cell and ``dynamic_decode``.

Beams are folded into the batch (B * K rows through the cell), the step
loop runs on the host with the state on the device, and ``finalize``
backtraces with ``F.gather_tree``.  A step is the reference's: the
log-softmax of the logits in fp32 (``jax.nn.log_softmax``'s formula), a
finished beam extends only with ``end_token`` at no cost (its other
tokens at -inf: the reference adds 1e-38 inside a log, which its eager
step flushes to zero, ROADMAP §C), and the top K of the B x (K * V) sums
keep the lower flat index on ties, as ``lax.top_k`` does.  Ids are
int64.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .functional.extras import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


def _log_softmax(x):
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


class Decoder:
    """The step-decoder interface ``dynamic_decode`` drives:

    - ``initialize(inits) -> (first_inputs, states)``
    - ``step(time, inputs, states, **kwargs) -> (outputs, states,
      parents)`` (``parents`` None for a decoder without beams)
    - ``finalize(step_outputs, step_parents, final_states) -> (outputs,
      final_states)``
    """

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, step_outputs, step_parents, final_states):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell`` (``cell(inputs, states) -> (out,
    new_states)``); ``embedding_fn`` maps token ids to the cell's inputs,
    ``output_fn`` its output to vocabulary logits."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """(B, ...) -> (B * K, ...), each row repeated K times."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def _merge(self, x):                      # (B, K, ...) -> (B * K, ...)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def _split(self, x, B):                   # (B * K, ...) -> (B, K, ...)
        return x.reshape((B, self.beam_size) + tuple(x.shape[1:]))

    def _top(self, flat):
        """The K largest of each row of ``flat`` (B, K * V) and their
        indices, the lower index first on ties (``lax.top_k``'s order)."""
        order = torch.sort(flat, dim=-1, descending=True, stable=True)
        K = self.beam_size
        return order.values[:, :K], order.indices[:, :K]

    def initialize(self, initial_cell_states):
        states = tree_map(lambda s: torch.repeat_interleave(
            s, self.beam_size, dim=0), initial_cell_states)
        some = tree_leaves(states)[0]
        B, dev = some.shape[0] // self.beam_size, some.device
        ids = torch.full((B, self.beam_size), self.start_token,
                         dtype=torch.int64, device=dev)
        # beam 0 live, the others at -1e9 so the first top-k takes no clone
        log_probs = torch.tensor([[0.0] + [-1e9] * (self.beam_size - 1)],
                                 device=dev).repeat(B, 1)
        finished = torch.zeros((B, self.beam_size), dtype=torch.bool,
                               device=dev)
        return ids, {"cell": states, "log_probs": log_probs,
                     "finished": finished}

    def step(self, time, inputs, states, **kwargs):
        B, K = states["log_probs"].shape
        emb = self._merge(inputs)
        if self.embedding_fn is not None:
            emb = self.embedding_fn(emb)
        cell_out, new_cell = self.cell(emb, states["cell"])
        logits = self.output_fn(cell_out) if self.output_fn is not None \
            else cell_out
        V = logits.shape[-1]
        logp = self._split(_log_softmax(logits.float()), B)      # (B, K, V)
        end_row = torch.full((V,), float("-inf"), device=logp.device)
        end_row[self.end_token] = 0.0
        masked = torch.where(states["finished"][:, :, None], end_row, logp)
        total = states["log_probs"][:, :, None] + masked
        top_val, top_idx = self._top(total.reshape(B, K * V))
        parent, token = top_idx // V, top_idx % V
        rows = torch.arange(B, device=logp.device)[:, None]
        new_cell = tree_map(
            lambda s: self._merge(self._split(s, B)[rows, parent]), new_cell)
        finished = states["finished"][rows, parent] | (token ==
                                                       self.end_token)
        return token, {"cell": new_cell, "log_probs": top_val,
                       "finished": finished}, parent

    def finalize(self, step_ids, step_parents, final_states):
        full = gather_tree(torch.stack(step_ids), torch.stack(step_parents))
        return full, final_states


def dynamic_decode(decoder, inits=None, max_step_num=100,
                   output_time_major=False, is_test=False,
                   return_length=False, **kwargs):
    """Run ``decoder`` until every beam finishes or ``max_step_num``
    steps: (ids (B, K, T), or (T, B, K) when ``output_time_major``; the
    final log-probabilities), and with ``return_length`` each beam's
    length (its first ``end_token`` + 1, else T).  ``kwargs`` go to every
    step."""
    ids, states = decoder.initialize(inits)
    step_ids, step_parents = [], []
    tokens = ids
    for t in range(max_step_num):
        tokens, states, parents = decoder.step(t, tokens, states, **kwargs)
        step_ids.append(tokens)
        step_parents.append(parents)
        if bool(states["finished"].all()):
            break
    seq, final_states = decoder.finalize(step_ids, step_parents, states)
    if not output_time_major:
        seq = seq.permute(1, 2, 0)                          # (B, K, T)
    if not return_length:
        return seq, final_states["log_probs"]
    tdim = 0 if output_time_major else -1
    is_end = seq == decoder.end_token
    pos = torch.argmax(is_end.int(), dim=tdim)
    length = torch.where(is_end.any(dim=tdim), pos + 1,
                         torch.full_like(pos, seq.shape[tdim]))
    return seq, final_states["log_probs"], length

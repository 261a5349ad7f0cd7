"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``).

The reference's ``_scan_rnn`` is a ``lax.scan``; here the time loop is a
Python loop of plain PyTorch ops (cuDNN's RNN rounds differently), with
the reference's math and gate order: LSTM i, f, g, o; GRU r, z, n with
``r * (h @ W_hn + b_hn)``.  A step past a row's ``sequence_length`` keeps
its state and repeats it as the output, as the reference's masked scan
does.  Weights keep paddle's layout (``weight_ih`` (gates * hidden,
input)) and the reference's names (``weight_ih_l{k}[_reverse]``, ...), so
``nn.params_from_numpy`` loads the reference's with no mapping.  Every
weight is drawn from ``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))`` in the
reference's order, and the dropout between layers is ``F.dropout``'s draw
from ``core.rng``: a model built and run after ``seed(s)`` is the
reference's.
"""

from __future__ import annotations

import math

import torch

from ..initializer import Uniform
from .base import Layer
from .containers import LayerList

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _uniform_init(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return Uniform(-std, std)


def _create_weights(layer, gates, input_size, hidden_size, attrs):
    """The four parameters of one cell, in the reference's order."""
    init = _uniform_init(hidden_size)
    wi_attr, wh_attr, bi_attr, bh_attr = attrs
    g = gates * hidden_size
    return (layer.create_parameter([g, input_size], wi_attr,
                                   default_initializer=init),
            layer.create_parameter([g, hidden_size], wh_attr,
                                   default_initializer=init),
            layer.create_parameter([g], bi_attr, is_bias=True,
                                   default_initializer=init),
            layer.create_parameter([g], bh_attr, is_bias=True,
                                   default_initializer=init))


def _step(mode, xw, h, c, wh, bh):
    """One time step from the input's projection ``xw = x @ wi.T + bi``:
    the new (h, c) (c passes through unless ``mode`` is LSTM)."""
    if mode == "LSTM":
        gates = xw + h @ wh.T + bh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(nc), nc
    if mode == "GRU":
        hg = h @ wh.T + bh
        xr, xz, xn = torch.chunk(xw, 3, dim=-1)
        hr, hz, hn = torch.chunk(hg, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    pre = xw + h @ wh.T + bh
    return (torch.tanh(pre) if mode == "RNN_TANH" else torch.relu(pre)), c


def _run_direction(mode, x, h0, c0, weights, time_major, reverse=False,
                   seq_lens=None):
    """One direction of one layer over ``x`` ((B, T, I), or (T, B, I)
    when ``time_major``): (outputs like ``x`` with hidden features, h_T,
    c_T)."""
    wi, wh, bi, bh = weights
    xs = x if time_major else x.transpose(0, 1)                 # (T, B, I)
    T = xs.shape[0]
    if reverse:
        xs = torch.flip(xs, [0])
    xw = xs @ wi.T + bi
    h = h0
    c = c0 if c0 is not None else torch.zeros_like(h0)
    lens = None if seq_lens is None else torch.as_tensor(
        seq_lens, device=x.device)
    outs = []
    for t in range(T):
        nh, nc = _step(mode, xw[t], h, c, wh, bh)
        if lens is not None:
            valid = ((T - 1 - t if reverse else t) < lens)[:, None]
            nh = torch.where(valid, nh, h)
            nc = torch.where(valid, nc, c)
        h, c = nh, nc
        outs.append(nh)
    outs = torch.stack(outs)
    if reverse:
        outs = torch.flip(outs, [0])
    return (outs if time_major else outs.transpose(0, 1)), h, c


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """(batch, hidden_size) of ``init_value`` in the layer's dtype on
        ``batch_ref``'s device (``shape`` and ``dtype`` are ignored, as
        in the reference)."""
        batch = batch_ref.shape[batch_dim_idx]
        return torch.full((batch, self.hidden_size), init_value,
                          dtype=self._dtype, device=batch_ref.device)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _create_weights(
            self, 1, input_size, hidden_size,
            (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        mode = "RNN_TANH" if self.activation == "tanh" else "RNN_RELU"
        out, _ = _step(mode, inputs @ self.weight_ih.T + self.bias_ih,
                       states, None, self.weight_hh, self.bias_hh)
        return out, out

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _create_weights(
            self, 4, input_size, hidden_size,
            (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = (self.get_initial_states(inputs),
                      self.get_initial_states(inputs))
        h, c = states
        new_h, new_c = _step("LSTM", inputs @ self.weight_ih.T + self.bias_ih,
                             h, c, self.weight_hh, self.bias_hh)
        return new_h, (new_h, new_c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        (self.weight_ih, self.weight_hh, self.bias_ih,
         self.bias_hh) = _create_weights(
            self, 3, input_size, hidden_size,
            (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        new_h, _ = _step("GRU", inputs @ self.weight_ih.T + self.bias_ih,
                         states, None, self.weight_hh, self.bias_hh)
        return new_h, new_h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNNBase(LayerList):
    """``num_layers`` stacked recurrent layers, each one or two
    directions (``direction`` "bidirect"/"bidirectional"), over (B, T, I)
    inputs or (T, B, I) ones when ``time_major``.  ``dropout`` drops the
    outputs of every layer but the last, in training.  ``forward`` gives
    (outputs, final states): h (or (h, c) for LSTM) of shape
    (num_layers * directions, B, hidden)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.mode, self.input_size = mode, input_size
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.time_major, self.dropout = time_major, dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                suffix = "_reverse" if d == 1 else ""
                names = tuple(f"{kind}_l{layer}{suffix}" for kind in (
                    "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
                for n, p in zip(names, _create_weights(
                        self, _GATES[mode], in_sz, hidden_size, attrs)):
                    self.register_parameter(n, p)
                self._weight_names.append(names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from .. import functional as F
        batch = inputs.shape[1 if self.time_major else 0]
        dirs = self.num_directions
        if initial_states is None:
            shape = (self.num_layers * dirs, batch, self.hidden_size)
            z = torch.zeros(shape, dtype=self._dtype, device=inputs.device)
            initial_states = (z, torch.zeros_like(z)) \
                if self.mode == "LSTM" else z
        if self.mode == "LSTM":
            h_all, c_all = initial_states
        else:
            h_all, c_all = initial_states, None
        out = inputs
        final_h, final_c = [], []
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(dirs):
                idx = layer * dirs + d
                weights = [getattr(self, n) for n in self._weight_names[idx]]
                outs, h_t, c_t = _run_direction(
                    self.mode, out, h_all[idx],
                    None if c_all is None else c_all[idx], weights,
                    self.time_major, reverse=(d == 1),
                    seq_lens=sequence_length)
                dir_outs.append(outs)
                final_h.append(h_t)
                final_c.append(c_t)
            out = torch.cat(dir_outs, dim=-1) if dirs == 2 else dir_outs[0]
            if self.dropout > 0 and layer < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        h_stack = torch.stack(final_h)
        if self.mode == "LSTM":
            return out, (h_stack, torch.stack(final_c))
        return out, h_stack


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        kwargs.pop("proj_size", None)
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class RNN(Layer):
    """A cell run over time (reversed when ``is_reverse``): (outputs
    stacked on the time axis, final states).  ``sequence_length`` is
    accepted and, as in the reference, not used; extra keyword arguments
    go to the cell."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse, self.time_major = is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        outputs, states = [], initial_states
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        for t in steps:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            out, states = self.cell(x_t, states, **kwargs)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return torch.stack(outputs, dim=time_axis), states


class BiRNN(Layer):
    """A forward and a reversed :class:`RNN`, their outputs concatenated
    on the feature axis, their states a pair."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length,
                                    **kwargs)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length,
                                    **kwargs)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNNBase",
           "SimpleRNN", "LSTM", "GRU", "RNN", "BiRNN"]

"""Layer containers (counterpart of ``paddle_tpu/nn/layer/containers.py``):
``Sequential`` and ``LayerList``, whose children are named "0", "1", ...
(so names come out as ``layer1.0.conv1.weight``, as in the reference)."""

from __future__ import annotations

from .base import Layer


class Sequential(Layer):
    """Layers run in order; ``Sequential([(name, layer), ...])`` or
    ``(name, layer)`` arguments name them."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        if isinstance(idx, str):
            return self._modules[idx]
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, input):
        for layer in self._modules.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._modules[str(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


__all__ = ["Sequential", "LayerList"]

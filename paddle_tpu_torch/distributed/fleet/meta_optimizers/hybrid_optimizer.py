"""HybridParallelOptimizer facade.

Reference: fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py:173
— wraps the inner optimizer, fuses DP allreduce (fused_allreduce_gradients),
re-scopes global-norm clip to psum over model-parallel axes
(HybridParallelClipGrad).

In the port (a copy of the reference's facade): the DP all-reduce runs in
the train-step builders; what remains is (a) the eager facade API, (b)
clip re-scoping: the mesh axes injected into ClipGradByGlobalNorm, whose
squared norm is then summed over those axes' process groups.
"""

from __future__ import annotations


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = getattr(optimizer, "_grad_clip", None)
        if clip is not None and hasattr(clip, "axes") and hcg is not None:
            axes = []
            if hcg.get_model_parallel_world_size() > 1:
                axes.append("model")
            if hcg.get_pipe_parallel_world_size() > 1:
                axes.append("pipe")
            clip.axes = axes or None

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner_opt.minimize(loss, startup_program, parameters,
                                        no_grad_set)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

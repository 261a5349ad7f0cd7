#!/usr/bin/env python3
"""Time two builds of the port's kernels against each other on
one card, in turns.

    git show <rev>:paddle_tpu_torch/csrc/flash_attention.cu > .scratch/fa.cu
    git show <rev>:paddle_tpu_torch/csrc/ragged_paged_attention.cu \\
        > .scratch/rpa.cu
    python3 flash_ab.py .scratch/fa.cu --ragged .scratch/rpa.cu
    python3 flash_ab.py --paged .scratch/pa.cu --fused .scratch/fused.cu

Builds each given source (with the checkout's ``csrc`` headers and
``_build``'s flags) into a throwaway library beside it, and the checkout's
own sources as ``_build`` does.  Both builds are held against the plain
versions first, then timed with ``chip_smoke.time_cold_ms`` (L2 flushed
before every launch) in the order old, new, new, old:

- flash (the positional source): ``flash_fwd``, ``flash_bwd_dq`` and
  ``flash_bwd_dkv`` at the phase-6 shapes (B 16, L 1024, H 12, D 64, bf16,
  causal), the phase-9 shapes (B 16, L 512, not causal) and the
  admission-prefill shape (B 1, L 128, causal), with SDPA's forward and
  whole backward beside them;
- ragged (``--ragged``, a source whose C interface takes no plan, as
  the per-row kernel's did): ``ragged_paged_attention`` at phase 1's
  mixed bf16 pack and its decode-only bf16 pack, the new build with the
  pack's plan built beforehand as the engine does, and each build's host
  time a call; then the phase-3 serve with each build: its wall ms a
  step untraced in three rounds, and 20 steps traced by
  ``torch.profiler`` (device busy a step and the kernels by time).

- paged (``--paged``, a ``paged_attention.cu`` whose C interface takes
  no workspace, as the per-(slot, head) kernel's did):
  ``paged_decode_attention`` at the phase-12 decode shape (S 8, nh 12, hd
  64, bs 32, C 20, clocks 128-639, bf16), then the phase-12 serve with
  each build in the order old, new, new, old, its syncs 40-59 traced
  (device busy a sync and the paged kernel's ms a sync);
- fused (``--fused``, a ``fused.cu`` whose ``fused_ln_bwd`` takes no grid,
  as the 16-rows-a-block kernel's did): ``fused_ln_bwd`` with the PyTorch
  sum of its partials, and the kernel alone, at BERT's LN shape (N 8192,
  H 768, bf16, bias, rout cotangent); then the phase-9 BERT step with
  each build in turns, 3 steps traced a turn (device busy a step and the
  LN backward kernel's ms a step).

Prints one line a kernel and shape, the card's ``nvidia-smi`` name and
power limit first.  Needs a CUDA card.
"""

import argparse
import ctypes
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import fused as TF
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

SHAPES = [("phase-6", 16, 1024, True), ("phase-9", 16, 512, False),
          ("prefill", 1, 128, True)]
TURNS = ("old", "new", "new", "old")


def build_old(src: Path) -> ctypes.CDLL:
    out = src.with_suffix(".so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    cs.check(r.returncode == 0, f"old build failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out))


def kernel_of(lib):
    """A stand-in for ``attention._kernel`` that reads from ``lib``."""
    new = A._kernel

    def get(name):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            ref = new(name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        return fn
    return get


def in_turns(builds, use, fn):
    """{old, new: [ms, ms]} of ``fn`` timed in the order old, new, new,
    old, ``use(build)`` selecting a build before each turn."""
    ms = {"old": [], "new": []}
    for turn in TURNS:
        use(builds[turn])
        ms[turn].append(cs.time_cold_ms(fn))
    use(builds["new"])
    return ms


def say_ab(what, ms, card, lib_ms=None, bound=None):
    old, new = (sum(ms[t]) / 2 for t in ("old", "new"))
    extra = ("" if lib_ms is None else
             f", sdpa {lib_ms:.4f} ms (new / sdpa {new / lib_ms:.2f}x, old / "
             f"sdpa {old / lib_ms:.2f}x)")
    extra += "" if bound is None else f", bound {bound[0]:.4f} ms ({bound[1]})"
    cs.say(f"ab {what} on {card}: old {ms['old'][0]:.4f}/{ms['old'][1]:.4f} "
           f"ms, new {ms['new'][0]:.4f}/{ms['new'][1]:.4f} ms, old / new "
           f"{old / new:.2f}x{extra}")


def ab_flash(src, card):
    builds = {"new": A._kernel, "old": kernel_of(build_old(src))}

    def use(build):
        A._kernel = build

    H, D, dt, scale = 12, 64, torch.bfloat16, 0.125
    for label, B, L, causal in SHAPES:
        q, k, v, do, km = cs.flash_inputs(B, L, H, D, dt, False, seed=7)
        out_p, lse = A.flash_fwd_ref(q, k, v, km, 0, causal, scale, 0.0)
        delta = (do.float() * out_p.float()).sum(-1).permute(0, 2, 1) \
            .reshape(B * H, L).contiguous()
        bwd = (q, k, v, km, 0, do, lse, delta, causal, scale, 0.0)
        dq_p, dk_p, dv_p = A.flash_bwd_ref(*bwd)
        calls = {"flash_fwd": lambda: A.flash_fwd_cuda(q, k, v, km, 0, causal,
                                                       scale, 0.0),
                 "flash_bwd_dq": lambda: A.flash_bwd_dq_cuda(*bwd),
                 "flash_bwd_dkv": lambda: A.flash_bwd_dkv_cuda(*bwd)}
        for name, build in builds.items():            # both right first
            use(build)
            out, _ = calls["flash_fwd"]()
            dq = calls["flash_bwd_dq"]()
            dk, dv = calls["flash_bwd_dkv"]()
            errs = (cs.rel_err(out, out_p), cs.rel_err(dq, dq_p),
                    cs.rel_err(dk, dk_p), cs.rel_err(dv, dv_p))
            cs.check(max(errs) <= cs.GRAD_TOL[dt],
                     f"{name} build disagrees at {label}: {errs}")
        use(builds["new"])
        qh, kh, vh, doh = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        lib = {"flash_fwd": cs.time_cold_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal))}
        leaves = [t.requires_grad_() for t in (qh, kh, vh)]
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal)
        lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = cs.time_cold_ms(
            lambda: torch.autograd.grad(o, leaves, doh, retain_graph=True))
        for name, fn in calls.items():
            say_ab(f"{name} at {label} (B {B}, L {L}, H {H}, D {D}, bf16, "
                   f"{'causal' if causal else 'not causal'})",
                   in_turns(builds, use, fn), card, lib[name],
                   cs.flash_bound(name, B, L, H, D, dt, causal))


def old_ragged_call(lib):
    """The old build's ``ragged_paged_attention`` (the per-row kernel's
    interface: no plan, no scratch) with ``ragged_attention_cuda``'s
    arguments and argument checks, as its wrapper was; 16-bit or fp32
    pools only."""
    fn = lib.ragged_paged_attention
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, pk, pv, table, rs, rp, pad, plan=None):
        rpa._check_kernel_args(q, pk, pv, table, rs, rp, pad)
        T, nh, hd = q.shape
        out = torch.empty_like(q)
        rc = fn(rpa._DTYPE_CODE[q.dtype], 0, hd, q.data_ptr(), pk.data_ptr(),
                pv.data_ptr(), None, None, table.data_ptr(), rs.data_ptr(),
                rp.data_ptr(), pad.data_ptr(), out.data_ptr(), T, nh,
                pk.shape[1], table.shape[1], table.shape[0],
                1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"old ragged kernel launch failed ({rc})")
        return out
    return call


def ab_ragged(src, card):
    old = old_ragged_call(build_old(src))
    packs = [("phase 1's mixed bf16 pack (T 256, 254 rows)",
              cs.make_pack(torch.bfloat16, False, seed=0)),
             ("phase 1's decode-only bf16 pack (8 rows, 3 at C*bs - 1)",
              cs.make_pack(torch.bfloat16, False, seed=6,
                           rows=cs.DECODE_ROWS))]
    for label, c in packs:
        args = cs.pack_args(c)
        plan = rpa.ragged_plan(*args[4:])
        builds = {"old": lambda: old(*args),
                  "new": lambda: rpa.ragged_attention_cuda(*args, plan=plan)}
        want = rpa.ragged_attention_ref(*args)
        real = [i for i, (s, p) in enumerate(c["rows"])
                if p >= 0 and p >= c["pads"][s]]
        for name, fn in builds.items():                # both right first
            got = fn()
            err = (got[real].float() - want[real].float()).abs().max().item()
            cs.check(err <= cs.TOL[torch.bfloat16],
                     f"{name} ragged build disagrees at {label}: {err}")
        current = {}
        ms = in_turns(builds, lambda b: current.update(fn=b),
                      lambda: current["fn"]())
        say_ab(f"ragged_paged_attention at {label}", ms, card,
               bound=cs.pack_bound(c))
        meta = [t.cpu() for t in args[4:]]        # as the engine holds it
        cs.say(f"ab ragged host time a call at {label}: old "
               f"{host_us(builds['old']):.1f} us, new "
               f"{host_us(builds['new']):.1f} us (plan given); "
               f"ragged_plan of the pack on CPU tensors "
               f"{host_us(lambda: rpa.ragged_plan(*meta)):.1f} us")
    ab_ragged_serve(old, card)


def host_us(fn, n=300):
    """Host time of one call of ``fn`` (argument checks, allocation,
    launches), with the device kept busy so no launch waits on it."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def ab_ragged_serve(old, card):
    """The phase-3 serve (gpt2-small, bf16, the ``gpt_serving`` traffic)
    with each build: three rounds of old, new, new, old untraced (wall ms
    a step), then one serve of each with steps 60-79 traced (device busy a
    step and the ragged kernels' share, as the serve's own packs see them:
    warm L2, mostly short decode rows).  Both builds run behind the same
    engine, which builds each pack's plan on the host."""
    from paddle_tpu_torch.models.gpt import GPTModel, gpt_preset

    cfg = gpt_preset("gpt2-small", compute_dtype="bfloat16")
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    reqs = cs.serving_traffic(cfg.vocab_size)
    new = rpa.ragged_attention_cuda
    cs.serve(model, reqs)                               # warm-up
    walls = {"old": [], "new": []}
    for turn in TURNS * 3:
        rpa.ragged_attention_cuda = old if turn == "old" else new
        eng, wall = cs.serve(model, reqs)[:2]
        walls[turn].append(1e3 * wall / eng.ragged_steps)
    for turn in ("old", "new"):
        rpa.ragged_attention_cuda = old if turn == "old" else new
        cs.say(f"ab serve, {turn} ragged kernel, on {card}, traced:")
        cs.serve(model, reqs, profile_steps=(60, 80))
    rpa.ragged_attention_cuda = new
    cs.say(f"ab serve ms/step untraced on {card}: old "
           f"{' '.join(f'{w:.3f}' for w in walls['old'])} (median "
           f"{np.median(walls['old']):.3f}), new "
           f"{' '.join(f'{w:.3f}' for w in walls['new'])} (median "
           f"{np.median(walls['new']):.3f})")


def old_paged_call(lib):
    """The old build's ``paged_decode_attention`` (no workspace, no tile)
    with ``paged_decode_attention_cuda``'s arguments and checks."""
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, pk, pv, table, t, pad_lens=None):
        pa._check_kernel_args(q, pk, pv, table, t, pad_lens)
        S, nh, hd = q.shape
        out = torch.empty_like(q)
        rc = fn(pa._DTYPE_CODE[q.dtype], hd, q.data_ptr(), pk.data_ptr(),
                pv.data_ptr(), table.data_ptr(), t.data_ptr(),
                None if pad_lens is None else pad_lens.data_ptr(),
                out.data_ptr(), S, nh, pk.shape[1], table.shape[1],
                1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"old paged kernel launch failed ({rc})")
        return out
    return call


def ab_paged(src, card):
    old = old_paged_call(build_old(src))
    new = pa.paged_decode_attention_cuda
    c = cs.serve_decode_case()
    args = cs.decode_args(c)
    want = pa.paged_decode_attention_ref(*args).float()
    builds = {"old": lambda: old(*args), "new": lambda: new(*args)}
    for name, fn in builds.items():                    # both right first
        err = (fn().float() - want).abs().max().item()
        cs.check(err <= 2e-5 + 2.0 ** -7 * want.abs().max().item(),
                 f"{name} paged build disagrees: {err}")
    current = {}
    say_ab("paged_decode_attention at the phase-12 decode shape (S 8, nh 12, "
           "hd 64, bs 32, C 20, clocks 128-639, bf16)",
           in_turns(builds, lambda b: current.update(fn=b),
                    lambda: current["fn"]()), card, bound=cs.decode_bound(c))
    cs.say(f"ab paged host time a call: old {host_us(builds['old']):.1f} us, "
           f"new {host_us(builds['new']):.1f} us")
    model, reqs, _, paged = cs.bucketed_serve()
    cs.serve_upfront(paged(), [(p, 16) for p, _ in reqs[:8]])  # warm-up
    for turn in TURNS:
        pa.paged_decode_attention_cuda = old if turn == "old" else new
        cs.say(f"ab serve, {turn} paged kernel, on {card}, syncs 40-59 "
               f"traced:")
        cs.serve_upfront(paged(), reqs, profile_steps=(40, 60),
                         kernel="paged_decode")
    pa.paged_decode_attention_cuda = new


def old_ln_bwd(lib):
    """The old build's ``fused_ln_bwd`` (no grid argument; one partial row
    a ``fused_ln_bwd_rows()`` rows) as ``fused_ln_bwd_cuda`` was: the
    kernel, then one PyTorch sum of its partials; ``partials_only`` stops
    after the kernel."""
    fn = lib.fused_ln_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 3 + [ctypes.c_uint32] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rows = lib.fused_ln_bwd_rows()

    def call(dout, drout, rout, mu, rstd, w, seed, dropout_p, has_bias,
             partials_only=False):
        drop, mixed, thresh, keep_div = TF._dropout_args(seed, dropout_p)
        N, H = TF._check_rows("old fused_ln_bwd", dout,
                              (rout,) if drout is None else (rout, drout),
                              (w,), (mu, rstd))
        w32 = TF._f32_vec(w)
        dx, dres = torch.empty_like(dout), torch.empty_like(dout)
        part = torch.empty(-(-N // rows), 3, H, dtype=torch.float32,
                           device=dout.device)
        rc = fn(TF._DTYPE_CODE[dout.dtype], dout.data_ptr(), TF._ptr(drout),
                rout.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                w32.data_ptr(), dx.data_ptr(), dres.data_ptr(),
                part.data_ptr(), N, H, drop, mixed, thresh, keep_div,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"old fused_ln_bwd launch failed ({rc})")
        if partials_only:
            return dx, dres, part
        dw, db, dbias = part.sum(0).unbind(0)
        return dx, dres, dw, db, dbias if has_bias else None
    return call


def ab_fused(src, card):
    old = old_ln_bwd(build_old(src))
    new = TF.fused_ln_bwd_cuda
    N, H, dt = 8192, 768, torch.bfloat16
    x, res, w, b, bb, dout, drout = cs.ln_inputs(N, H, dt, True, seed=11)
    _, rout, mu, rstd = TF.fused_ln_fwd_cuda(x, res, w, b, bb, 0, 0.0, 1e-12)
    bwd = (dout, drout, rout, mu, rstd, w, 0, 0.0, True)
    want = TF.ln_bwd_ref(*bwd)
    builds = {"old": lambda: old(*bwd), "new": lambda: new(*bwd)}
    for name, fn in builds.items():                    # both right first
        errs = [cs.rel_err(a, c) for a, c in zip(fn(), want)]
        cs.check(max(errs) <= cs.GRAD_TOL[dt],
                 f"{name} fused_ln_bwd build disagrees: {errs}")
    label = ("fused_ln_bwd at BERT's LN shape (N 8192, H 768, bf16, bias, "
             "rout cotangent)")
    bound = cs.bytes_ops_bound(5 * N * H * 2 + 2 * N * 4 + 4 * H * 4,
                               15 * N * H)
    current = {}
    use = lambda b: current.update(fn=b)
    say_ab(f"{label}, kernel and sum", in_turns(
        builds, use, lambda: current["fn"]()), card, bound=bound)
    alone = {"old": lambda: old(*bwd, partials_only=True),
             "new": lambda: TF.ln_bwd_partials_cuda(*bwd[:-1])}
    say_ab(f"{label}, kernel alone", in_turns(
        alone, use, lambda: current["fn"]()), card, bound=bound)
    from paddle_tpu_torch.core.flags import set_flags

    set_flags({"FLAGS_use_fused_ln": True})
    _, _, step, state, batch = cs.bert_base_train()
    for _ in range(3):                                  # warm-up
        state, _ = step(state, 1e-4, *batch)
    for turn in TURNS:
        TF.fused_ln_bwd_cuda = old if turn == "old" else new
        state, _ = step(state, 1e-4, *batch)
        cs.say(f"ab BERT step, {turn} LN backward, on {card}, 3 steps "
               f"traced:")
        prof = cs.start_profile()
        for _ in range(3):
            state, loss = step(state, 1e-4, *batch)
        cs.report_profile(prof, 3, kernel="ln_bwd_kernel")
        cs.check(math.isfinite(loss.item()), "ab BERT step: non-finite loss")
    TF.fused_ln_bwd_cuda = new
    set_flags({"FLAGS_use_fused_ln": False})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("flash", nargs="?", type=Path,
                    help="an old flash_attention.cu")
    ap.add_argument("--ragged", type=Path,
                    help="an old ragged_paged_attention.cu")
    ap.add_argument("--paged", type=Path, help="an old paged_attention.cu")
    ap.add_argument("--fused", type=Path, help="an old fused.cu")
    opts = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs a CUDA card")
    cs.check(any(x is not None for x in (opts.flash, opts.ragged, opts.paged,
                                         opts.fused)),
             "give an old flash source, --ragged OLD, --paged OLD or "
             "--fused OLD")
    card = cs.card_line()
    cs.say(f"card: {card}")
    _build.build_all()
    if opts.flash is not None:
        ab_flash(opts.flash, card)
    if opts.ragged is not None:
        ab_ragged(opts.ragged, card)
    if opts.paged is not None:
        ab_paged(opts.paged, card)
    if opts.fused is not None:
        ab_fused(opts.fused, card)


if __name__ == "__main__":
    main()

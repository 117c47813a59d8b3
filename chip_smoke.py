"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --grad-seeds TASK BATCH SEED ...   (``grad_seeds``)

Builds the hand-written CUDA kernels of ``mdgen_finetune_tpu_torch/csrc``
from this checkout and holds each kernel against its plain PyTorch twin at
the shapes of its path (the sampler's forward kernels at B = 64, the
key-tiled frame attention and the trunk's three stage ops at T = 1000, the
training backward kernels at B = 32); ``ipa_attention`` (row c) in its
streaming form at the encoder's (6400, 4) and, in ``atlas_kernels``, in its
tensor-core form at L = 256 over 100 elements and over 1 and at
(Ch, Pq, Pv) = (16, 4, 6) (translations across +-40 A, the 56 padded
residues masked), and in its streaming form at L = 4 (``ipa_entry``: back
to back, the host's time, the parent's bits in the streaming form and the
parent's error in the tensor-core form, the 4-byte copy build, SDPA on
augmented heads, the bytes, f32 and TF32 bounds, the plan, the resources);
``rope_short``: the short body of ``rope_attention`` (N <= 16) at its
three uses (trunk stage 1, base 2; the modular layer's residue attention,
TPU row 12, natural; the encoder's residue MHA) and the streaming short
backward (row f') at its three uses: the training path's stage 1, the
T = 1000 training's and the merged route's residue stage at T = 200;
``bwd_kernels`` holds ``modln_bwd`` (row e) at the three training shapes
(flagship, T = 1000, ATLAS: ``shapes``, each with back to back, the host's
time, the parent's times and bits, the bound, the plain version, the
library yardstick, the device time of the kernel and of its split sum
apart by the profiler, "not measured" where no trace comes back whole;
the launches a call, one of each, asserted from a CUDA graph of one call)
and ``train_path`` asserts its 15 calls a step.
Then:

- the sampler: one denoiser step on the card against the same step on the
  CPU (and its launches: 32 ``adaln_linear``, 10 ``rope_attention``); the
  flagship forward-simulation sampler at full width (5 layers x 384, 16
  heads, prepend-IPA, L = 4, T = 100, B = 64, 100 Euler steps, bf16, seeded
  random weights) through ``InferenceEngine.sample`` and a 2-window
  ``rollout``; a ``torch.profiler`` trace of one more sample;
- the 4AA forward-simulation preset (``preset_4aa_sim``: T = 1000, same
  width): one velocity evaluation on the card against the CPU (B = 1);
  ``InferenceEngine.sample`` at B = 8 with Euler-100, then Heun-10 and the
  preset's dopri5 at B = 1 (accepted / rejected steps, evaluations); a
  trace of one B = 8 sample; the ``sim_inference`` CLI writing a
  2,000-frame PDB (dopri5) from a ``Trainer`` checkpoint, parsed back;
- the transition-path preset (``preset_4aa_tps``: T = 100, same width,
  the doubled offsets, the encoder's token pair over the start and end
  frames) over synthetic endpoints: ``tps_main`` (B = 64 Euler-100 on the
  flat chain, no ``forward_inference`` call; B = 1 dopri5; launches as
  derived, the encoder's equal to ``main_path``'s over twice the elements;
  the paired encoder against its two passes; one velocity card-vs-CPU),
  ``tps_trace``, ``tps_cli`` (a released-format ``.ckpt`` of the random
  weights, ``tps_inference --torch_ckpt`` on a 300-frame synthetic "AGHK"
  trajectory: 2 paths, the end structure conditioned) and
  ``upsampling_cli`` (``preset_4aa_upsampling`` from a ``Trainer``
  checkpoint, Euler-100, 2 windows of 1,000 frames), then ``analysis_cli``
  (the host-only ``analyze_sim``, ``analyze_tps`` and
  ``analyze_upsampling`` on what those three CLIs wrote, against their
  synthetic MD references: host seconds, finite JSDs in [0, 1]);
- the design preset (``preset_4aa_design``: inpainting + design +
  ``no_torsion``, T = 100, same width, latent 48 with 20 simplex channels)
  over synthetic trajectories: ``design_main`` (B = 64 Euler-100 on the
  generic chain, every step one ``forward_inference``: the trunk without
  the folded head, the FinalLayer and the design head, the encoder's pair
  plus ``x_d_to_emb`` over 128 elements; launches and rope bodies as
  derived; the designed sequence, the simplex sums, the c-factor card vs
  CPU on the warm-up's inputs, one evaluation card-vs-CPU),
  ``design_trace``, ``mpnn`` (``mpnn`` / ``dynamic_mpnn``: one evaluation,
  the trunk at T = 1 / 2 against its plain twins, the logits card-vs-CPU)
  and ``design_cli`` (``design_inference --torch_ckpt`` on a 300-frame
  "AGHK" trajectory, 2 samples, then ``analyze_design``);
- the reverse SDE, the likelihood and the ablations at the flagship's
  width: ``sde_main`` (``InferenceEngine(sampler="sde")``, B = 64
  Euler-Maruyama 100 steps + ``Mean``, 101 ``forward_inference``
  evaluations with launches as derived; the middle evaluation with the
  kernels against the plain twins in bf16 and f32 on the card; Heun +
  ``Tweedie`` at B = 8, 20 steps; card vs CPU at B = 2 with the same prior
  and noise) and ``sde_trace``; ``likelihood_main``
  (``InferenceEngine.log_likelihood`` at B = 16, 100 steps, each a
  ``FusedTrunkFn`` forward and its backward in x: launches as derived
  (``LIKELIHOOD_PER_STEP``), peak memory, ``prior_logp``, x0 and
  delta_logp against the twins and against the CPU with the same probes)
  and ``likelihood_trace`` (10 steps); ``sde_cli`` (``sim_inference --sde
  --sde_steps 50``, one 100-frame window); ``ablations`` (``no_offsets``
  B = 64 Euler-100 on the flat chain; ``no_frames``, latent 111 without
  the encoder: ``Trainer`` steps at B = 32, the fixed-batch loss falling,
  the N = 111 head on tiled64 against its f32 twin, and
  ``grad_cuda_vs_cpu_no_frames``);
- training the tasks the port samples, at full width and B = 32 on
  synthetic 1,000-frame trajectories (``train_cell`` each): ``train_design``
  (``preset_4aa_design``: the trunk without its head, the FinalLayer, the
  design head, the Dirichlet draw on the card) with ``train_design_trace``,
  ``train_mpnn`` and ``train_dynamic_mpnn`` (the trunk at T = 1 / 2),
  ``train_tps`` (``preset_4aa_tps``); rows b′ and f′ at the frame stage's
  T = 1 and 2 against their twins (``frame_rows_short_t``); the ``train``
  CLI with ``--design --inference_batches 1`` and its designability probe
  (``train_design_cli``); every gradient card vs CPU for design, mpnn and
  TPS (``grad_cuda_vs_cpu_design`` / ``_tps`` at B = 2, ``_mpnn`` at
  B = 32; the same simplex point; the all-twin card's run beside each);
- RTB posterior fine-tuning of the flagship prior (``rtb/``, seeded
  random weights, the surrogate reward, the CLI's defaults: sampling
  length 10, 1,000 DDPM timesteps, LoRA rank 32, adapters with a seeded
  nonzero b): ``rtb_main`` (``RTBTrainer.step`` at B = 4: 10 prior and 10
  posterior evaluations, the 100-step decode, the posterior's backward;
  ms per iteration, peak memory, launches per iteration as derived,
  ``rtb_launches_derived``) and ``rtb_trace``; ``rtb_checks`` (one
  posterior evaluation against its plain twins; at b = 0 the posterior's
  log-probs equal the prior's bit for bit); ``rtb_main_b32`` (B = 32, the
  peak memory of ten posterior forwards held for one backward);
  ``rtb_batched`` (``RTBBatchedTrainer``, B = 32, chunks of 4);
  ``grad_rtb_cuda_vs_cpu`` (B = 2, 2 layers, every adapter gradient,
  pf_divergence and the loss card vs CPU under the rule, the all-twin
  card beside); ``rtb_cli`` (``train_posterior``,
  ``train_conditional_posterior``, ``train_prior``); then the outsourced
  UNet policy, in f32 (TF32 off for its convolutions and matmuls, as every
  entry point of the port sets it, asserted): ``rtb_unet`` (``RTBTrainer(policy=UNet3DSeq(...),
  lora_targets=...)`` at the UNet's class defaults over the flagship latent,
  every parameter seeded nonzero, adapters on every Dense kernel, B = 4:
  one warm-up and 3 timed iterations, the launches per iteration those of
  the decode alone, ``rtb_unet_launches_derived``) and ``rtb_unet_trace``;
  ``rtb_unet_checks`` (b = 0 bit for bit; the decode's Euler step and
  encoder grid against their plain twins); ``rtb_unet_distill``
  (``DiffuserTrainer(model=)``, 20 steps, the held-out loss falls);
  ``grad_rtb_unet_cuda_vs_cpu`` (as ``grad_rtb_cuda_vs_cpu``, the UNet the
  posterior);
- training: the loss and every parameter's gradient on the card (bf16
  kernels) against the CPU (f32 twins) at full width, B = 2; the flagship
  config trained through ``Trainer`` at B = 32, T = 100, L = 4 (2 warm-up
  and 20 timed steps, 30 steps on one fixed batch, a checkpoint round
  trip) from the port's real init on synthetic "AAGG" / "GHKL"
  trajectories; a ``torch.profiler`` trace of one train step; the trunk's
  training forward and backward as a whole (B = 32), timed with the kernels
  and with their plain twins, and held to the twins in f32;
- training the 4AA preset at T = 1000 (B = 8, ``grad_checkpointing``): the
  ``fused_attention`` kernels (forward and backward, base 2 at the path's
  shape and the natural-exp softmax at N = 2048, D = 64), ``adaln_mlp_bwd``
  and ``time_attention_block_bwd`` against their plain twins
  (``long_bwd_kernels``); every parameter's gradient card-vs-CPU at B = 1
  (``grad_cuda_vs_cpu_1000``); ``Trainer`` for 2 warm-up and 10 timed
  steps, 20 steps on one fixed batch, a checkpoint round trip and the
  launches per step of all nine kernels (``train_1000``); a trace of one
  step (``train_1000_trace``); the ``train`` CLI with the reference's
  command, whose checkpoint drives one ``sim_inference`` window
  (``train_cli``);
- right after ``train_path`` and its trace, the merged layer backward
  (``MDGEN_FUSED_BWD=merged``, one cooperative launch per layer,
  ``csrc/fused_layer_bwd.cu``): ``merged_bwd_kernels``
  (B = 32, T = 100 and B = 4, T = 200: against the split route on the same
  inputs, bit for bit expected, and the f32 plain version under the
  composition rule; ms of the merged launch, of the split route's launches
  for one layer and of the plain version; the bound; ``phase_clock``: the
  kernel's time by phase from its ``-DMDGEN_PHASE_CLOCK`` build beside the
  split route's kernels for the same work, ``tools/merged_phase_clock``),
  then ``train_merged``
  (``train_path``'s run through it: the same losses and gradient norms bit
  for bit, 5 merged launches and no split backward kernel per step) and its trace ``train_merged_trace``;
- the ATLAS crop-256 preset (``preset_atlas``: L = 256, T = 250, B = 1,
  same width; synthetic ``{name}_R{1,2,3}_i40`` replicas of a 300-residue
  protein, which the crop cuts, and a 200-residue one, which it pads):
  ``atlas_kernels`` (``blocked_attention_bwd`` in both views, at N = 129
  and at its limit; the residue stage's core, ``tiled_attention`` and
  ``rope_attention``; ``ipa_attention`` at L = 256 and 4, and the
  key-tiled form at other widths, (Ch, Pq, Pv) = (16, 4, 6), at L = 256;
  ``residue_rows_block`` and the stage backwards as a whole);
  ``sim_atlas`` (one velocity evaluation card-vs-CPU, Euler-100 and the
  preset's dopri5 through ``InferenceEngine.sample``) and its trace;
  ``train_atlas`` (``Trainer``: 2 warm-up and 10 timed steps, 20 fixed-batch
  steps, a checkpoint round trip, launches per step) and its trace;
  ``grad_cuda_vs_cpu_atlas`` (every gradient card-vs-CPU, the trunk cut to
  1 layer); ``atlas_cli`` (``train`` with the ATLAS flags for 3 steps, then
  a 250-frame ``sim_inference`` window from its checkpoint, parsed back).

Last, ``micro_ops``: the micro-op probe (``tools/micro_ops`` of the
package) checks every op's plain and position-weighted sums against its
plain version and prints its marginal-cost table; its kernel line carries
the bound over the whole card and over the probe's 32 SMs. After it,
``parallel`` (``phase_parallel``): data and sequence parallelism with 2 and
4 gloo ranks spawned onto this one card (the flagship trained on 2 x 1 and
2 x 2, ATLAS on 1 x 2: a step, a velocity, an Euler-10 sample; a one-rank
NCCL group), each held to this process's run; the kernel line gives each
kernel's launches a rank under the batch fold and the sequence split.

With ``MDGEN_PARENT_CSRC`` set to the csrc directory of another checkout
(a ``git archive`` of the parent commit), built beside this checkout's
kernels from the start, the entries of ``ipa_attention`` (the streaming
form's bits asserted equal, the tensor-core form's error recorded beside
the parent's) and ``rope_attention_bwd``'s short body (its bits asserted
equal), of the probe (the parent's marginal-cost table beside this one), of
``rope_attention``'s short body, of the kernels that end in ``colsum.cuh``'s
second pass (``linear_bwd`` at every use, ``modln_bwd`` at three shapes,
``rope_attention_bwd``'s long body, ``blocked_attention_bwd``), of ``adaln_linear`` (every use), of
``fused_attention``'s forward (its three shapes: T = 1000 in both
softmaxes, the ``no_rope`` frame and residue views), of the merged layer
backward (its launch, and the split route on the parent's
``adaln_linear``), of the long-key attention kernels (``tiled_attention``,
``fused_attention_bwd``) and of the compositions around them
(``time_attention_block`` at T = 1000, ``residue_rows_block`` and the
stage backwards at ATLAS, ``time_attention_block_bwd``) also time that
checkout's kernels on the same inputs (``parent``); the kernels' entries
carry their launch resources (and the long-key ones the exp2 floor) either
way. ``main_path`` asserts ``adaln_linear``'s launches by route as derived
from the code, and the kernel line splits ``fused_attention``'s ``no_rope``
launches by form: the residue view (short form) and the frame view (long).

Each phase prints one JSON line; the kernel line (times, bounds, launches)
comes second to last, and the last line is ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero; without CUDA it exits
non-zero before printing any result. Scratch files go to
``workdir/chip_smoke/`` (listed in .gitignore) and are removed at the end.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
B, T, L, C, H, NL, STEPS = 64, 100, 4, 384, 16, 5, 100
B_TRAIN = 32  # the training shape of tools/train_step_bench.py
B_SIM, T_SIM = 8, 1000  # the 4AA forward-simulation preset (config.preset_4aa_sim)
SCRATCH = Path(__file__).resolve().parent / "workdir" / "chip_smoke"


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median of CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def back_to_back_ms(fn, n=50):
    """Mean time per call of ``n`` back-to-back calls between two CUDA
    events: the device's time per call wherever the host enqueues a call
    faster than its kernels run (the launch overhead that ``time_ms``
    includes is hidden)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, n=100):
    """The host's time per call of ``fn`` (the wrapper's Python and its
    launches): ``n`` calls on a host clock while the card sleeps through a
    kernel queued first, so that no call waits on the card; with
    ``time_ms`` and ``back_to_back_ms`` it says what a call's time by events
    spends on the host."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock: longer than the n calls
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return dt


def bound_ms(nbytes, flops, peak_flops=PEAK_BF16_FLOPS):
    """The least time for the work: bytes over the memory rate or operations
    over the peak rate for the inputs' type, whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


SFU_EX2_PER_CLOCK = 16  # exp2 per clock per SM on Hopper's special-function units


def max_sm_clock_hz():
    """The card's highest SM clock (nvidia-smi ``clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def ex2_floor_ms(n):
    """The least time for ``n`` exp2 on the SFUs of every SM at the highest
    SM clock: the floor of any attention kernel that forms one exp2 per
    (query, key), beside the bound (which counts bytes and products)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n / (SFU_EX2_PER_CLOCK * sms * max_sm_clock_hz()) * 1e3


def long_key_times(name, run, n_ex2, resources):
    """What the long-key attention kernels report beside ms: back to
    back, the parent's sources on the same inputs, the exp2 floor, the
    launch resources."""
    return dict(back_to_back_ms=back_to_back_ms(run), parent=parent_times(name, run),
                ex2_floor_ms=ex2_floor_ms(n_ex2), resources=resources)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check(name, got, ref, rel_tol):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if not (err <= rel_tol * scale) or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: max abs err {err} > {rel_tol} x {scale}")
    return err, rel_tol * scale


_PARENT_LIBS: dict = {}
_PARENT_BUILDS: list = []
# the kernels of the last slices: ipa_attention's tensor-core form and the
# probe's wgmma dots (this one), ipa_attention's streaming form and
# rope_attention_bwd's short body, rope_attention's short body and row 4',
# rows a and h, the long-key kernels; and the other callers of colsum.cuh's
# second pass (rows d, e, j)
PARENT_KERNELS = ("ipa_attention", "micro_ops", "rope_attention_bwd", "rope_attention",
                  "adaln_linear", "fused_attention", "fused_layer_bwd", "tiled_attention",
                  "fused_attention_bwd", "linear_bwd", "modln_bwd", "blocked_attention_bwd")


def start_parent_builds():
    """Start building the kernels of MDGEN_PARENT_CSRC (the csrc directory of
    another checkout, e.g. a ``git archive`` of the parent commit), one nvcc
    per source, beside this checkout's build; no-op without it."""
    from mdgen_finetune_tpu_torch.ops import _cuda

    parent = os.environ.get("MDGEN_PARENT_CSRC")
    if not parent or _PARENT_BUILDS:
        return
    out = SCRATCH / "parent_build"
    out.mkdir(parents=True, exist_ok=True)
    for n in PARENT_KERNELS:
        _PARENT_BUILDS.append((n, out / f"{n}.so", subprocess.Popen(
            [_cuda.nvcc(), *_cuda.FLAGS, "-o", str(out / f"{n}.so"), os.path.join(parent, f"{n}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)))


def parent_lib(name):
    """The library of kernel ``name`` built from MDGEN_PARENT_CSRC, or None
    without it: the kernel phases time those sources on the same inputs
    beside this checkout's (the builds started by ``start_parent_builds``)."""
    import ctypes

    if not os.environ.get("MDGEN_PARENT_CSRC") or name not in PARENT_KERNELS:
        return None
    if not _PARENT_LIBS:
        start_parent_builds()
        for n, so, p in _PARENT_BUILDS:
            if p.wait() != 0:
                raise RuntimeError(f"the parent's {n}.cu did not build")
            _PARENT_LIBS[n] = ctypes.CDLL(str(so))
    return _PARENT_LIBS[name]


@contextlib.contextmanager
def with_libs(libs):
    """This checkout's wrappers of the kernels named in ``libs`` running the
    libraries given there ({name: ctypes library})."""
    from mdgen_finetune_tpu_torch.ops import _cuda

    cur = {n: _cuda._LIBS[n] for n in libs}
    for n, lib in libs.items():
        fn, ref = getattr(lib, n), getattr(cur[n], n)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        _cuda._LIBS[n] = lib
    try:
        yield
    finally:
        _cuda._LIBS.update(cur)


def with_parent(names):
    """This checkout's wrappers of kernels ``names`` running the parent's
    libraries (``parent_lib``). The parent's entry points take the same
    arguments but the schedule that this checkout's wrappers append after
    the stream, which they do not read (a C call's trailing arguments)."""
    return with_libs({n: parent_lib(n) for n in names})


def parent_times(names, run):
    """ms by events and back to back of ``run`` on the parent's libraries
    of kernels ``names`` (one name or several), or None without
    MDGEN_PARENT_CSRC."""
    names = (names,) if isinstance(names, str) else names
    if parent_lib(names[0]) is None:
        return None
    with with_parent(names):
        return dict(ms=time_ms(run), back_to_back_ms=back_to_back_ms(run), host_ms=host_ms(run))


IPA_GENERAL = "MDGEN_IPA_GENERAL"  # ipa_attention's streaming form with 4-byte copies only


def ipa_sdpa(proj, rot, trans, mask, hw, H, Ch, Pq, Pv):
    """Row c's library yardstick on the inputs of ``ipa_attention``: the
    IPA logits as one product of augmented heads, q_aug = [q, q_pts],
    k_aug = [c k, w k_pts] (c = sqrt(1 / (3 Ch)), w = softplus(hw)
    sqrt(1 / (3 Pq 9 / 2))), plus the float mask -w/2 |k_pts|^2 +
    1e5 (m_q m_k - 1) at scale 1 (the per-query term -w/2 |q_pts|^2 does
    not change the softmax), values [v, v_pts]. The points are lifted here,
    outside the timed call; the inverse map and the norms are not timed
    either. Returns (q, k, v, mask) for SDPA, (B, H, L, .)."""
    import torch.nn.functional as F

    Bn, Lc, _ = proj.shape
    HCh, HPq, HPv = H * Ch, H * Pq, H * Pv

    def heads(t, P):
        return t.reshape(Bn, Lc, H, P).transpose(1, 2)

    def pts(lo, HP, P):
        t = proj[..., lo:lo + 3 * HP].reshape(Bn, Lc, 3, HP).transpose(-1, -2)
        g = (rot[:, :, None] * t[..., None, :]).sum(-1) + trans[:, :, None]
        return heads(g.reshape(Bn, Lc, H, P * 3), P * 3)

    q, k, v = (heads(proj[..., i * HCh:(i + 1) * HCh], Ch) for i in range(3))
    qp, kp, vp = pts(3 * HCh, HPq, Pq), pts(3 * HCh + 3 * HPq, HPq, Pq), pts(3 * HCh + 6 * HPq, HPv, Pv)
    w = (F.softplus(hw) * (1.0 / (3 * (Pq * 9.0 / 2))) ** 0.5)[None, :, None, None]
    am = -0.5 * w * (kp ** 2).sum(-1)[:, :, None, :] \
        + (1e5 * (mask[:, :, None] * mask[:, None, :] - 1))[:, None]
    return (torch.cat([q, qp], -1).contiguous(),
            torch.cat([(1.0 / (3 * Ch)) ** 0.5 * k, w * kp], -1).contiguous(),
            torch.cat([v, vp], -1).contiguous(), am.contiguous())


def ipa_flops(Bn, Lc, widths, Hi=4):
    """Row c's operations at (Bn, Lc): per (query, key, head) the f32 form's
    (a dot over Ch, a squared distance over 3 Pq, the value sums over Ch and
    3 Pv), and the tensor-core form's products in TF32 (the scalar columns
    once, the point columns three times: 3xTF32)."""
    Ch, Pq, Pv = widths
    pairs = Lc * Lc * Hi * Bn
    f32 = pairs * (2 * Ch + Pq * 3 * 3 + 2 * (Ch + Pv * 3))
    tf32 = pairs * 2 * (Ch + 3 * (3 * Pq) + Ch + 3 * (3 * Pv))
    return f32, tf32


def ipa_entry(dev, name, Bn, Lc, widths, mask_fn, seed, plain_reps=20, spread=None):
    """Row c at (Bn, Lc) and (Ch, Pq, Pv) = ``widths`` (4 heads), the
    translations ``randn x 5`` or uniform in +-``spread``: against its f32
    plain twin; by events, back to back and the wrapper's host time; the
    parent's sources on the same inputs (with MDGEN_PARENT_CSRC): in the
    streaming form bit for bit (asserted), in the tensor-core form (whose
    products cannot keep the parent's f32 bits) the parent's and this
    form's max error against the twin, recorded; in the streaming form the
    build with 4-byte copies only (``-DMDGEN_IPA_GENERAL``, its bits
    asserted); SDPA on the augmented heads (``ipa_sdpa``, its scalar
    features held to the twin's); the bound (bytes, and the operations: f32
    for the streaming form, TF32 products on the tensor cores for the
    tensor-core form, all three in ``bounds``); the launch resources (at the
    model's widths) and the plan."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.geometry.rigid import Rigid
    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.ops import ipa_attention as IA

    g = torch.Generator(device=dev).manual_seed(seed)
    Ch, Pq, Pv = widths
    Hi = 4
    proj = torch.randn(Bn, Lc, IA.proj_width(Hi, Ch, Pq, Pv), generator=g, device=dev)
    t7 = torch.randn(Bn, Lc, 7, generator=g, device=dev)
    t7[..., 4:] *= 5
    fr = Rigid.from_tensor_7(t7)
    trans = fr.trans.contiguous() if spread is None else \
        (torch.rand(Bn, Lc, 3, generator=g, device=dev) * 2 - 1) * spread
    emask = torch.ones(Bn, Lc, device=dev)
    mask_fn(emask)
    hw = torch.randn(Hi, generator=g, device=dev)
    args = (proj, fr.rot.contiguous(), trans, emask, hw)
    kw = dict(H=Hi, Ch=Ch, Pq=Pq, Pv=Pv)
    form = IA._form(Bn, Lc, Hi, Ch, Pq, Pv)
    n0 = IA.ipa_attention.forms[form]
    got = IA.ipa_attention(*args, **kw)
    if IA.ipa_attention.forms[form] != n0 + 1:
        raise AssertionError(f"ipa_attention[{name}]: the {IA.FORMS[form]} form did not run")
    ref = IA.ipa_attention_plain(*args, **kw)
    err = check(f"ipa_attention[{name}]", got, ref, 1e-2)
    run = lambda: IA.ipa_attention(*args, **kw)  # noqa: E731
    bits = parent_err = None
    if parent_lib("ipa_attention") is not None:
        with with_parent(("ipa_attention",)):
            before = IA.ipa_attention(*args, **kw)
        if form == 3:
            parent_err = (before.float() - ref.float()).abs().max().item()
        else:
            bits = torch.equal(before, got)
            if not bits:
                raise AssertionError(f"ipa_attention[{name}]: the features moved from the parent's bits")
    general = None
    if form == 0:
        with with_libs({"ipa_attention": _cuda.variant_library("ipa_attention", IPA_GENERAL)}):
            general = dict(bits_equal=torch.equal(run(), got), ms=time_ms(run),
                           back_to_back_ms=back_to_back_ms(run))
        if not general["bits_equal"]:
            raise AssertionError(f"ipa_attention[{name}]: the 4-byte copy path moved the bits")
    qa, ka, va, am = ipa_sdpa(*args, **kw)
    lib = lambda: F.scaled_dot_product_attention(qa, ka, va, attn_mask=am, scale=1.0)  # noqa: E731
    lib_err = check(f"ipa_attention[{name}] SDPA yardstick",
                    lib()[..., :Ch].transpose(1, 2).reshape(Bn, Lc, Hi * Ch), ref[..., :Hi * Ch],
                    1e-2)
    f32_ops, tf32_ops = ipa_flops(Bn, Lc, widths, Hi)
    moved = nbytes(*args) + got.numel() * 2
    bounds = dict(bytes_ms=bound_ms(moved, 0)[0], f32_ops_ms=f32_ops / PEAK_F32_FLOPS * 1e3,
                  tf32_3x_points_ops_ms=tf32_ops / PEAK_TF32_FLOPS * 1e3)
    plan = IA.tc_plan(Bn, Lc, Hi, Ch, Pq, Pv) if form == 3 else \
        (IA.ipa_plan(Bn, Lc, Hi, Ch, Pq, Pv) if form == 0 else None)
    return dict(
        shape=f"{Bn} elements x {Hi} heads, L={Lc}, Ch={Ch}, Pq={Pq}, Pv={Pv}"
              + ("" if spread is None else f", translations in +-{spread} A")
              + f", {int((emask == 0).sum().item())} masked residues",
        form=IA.FORMS[form], max_abs_err=err[0], tol=err[1],
        ms=time_ms(run), back_to_back_ms=back_to_back_ms(run), host_ms=host_ms(run),
        parent=parent_times("ipa_attention", run), bits_equal_parent=bits,
        parent_max_abs_err=parent_err, general_path=general,
        plain_ms=time_ms(lambda: IA.ipa_attention_plain(*args, **kw), reps=plain_reps),
        library_ms=time_ms(lib), library_back_to_back_ms=back_to_back_ms(lib),
        library_max_abs_err=lib_err[0],
        library_note="SDPA on augmented heads [q, q_pts] . [c k, w k_pts] with a float mask, "
                     "scale 1, values [v, v_pts]; the lift, the inverse map and the norms are "
                     "outside the timed call",
        bound=bound_ms(moved, tf32_ops, PEAK_TF32_FLOPS) if form == 3
        else bound_ms(moved, f32_ops, PEAK_F32_FLOPS), bounds=bounds,
        plan=dataclasses.asdict(plan) if plan is not None else None,
        resources=IA.resources(Bn, Lc) if widths == IA.REGISTER_WIDTHS and form in (0, 3) else None)


def phase_kernels(dev):
    """Each kernel against its plain twin (run in f32 on the same inputs) at
    the main path's shapes; times of kernel, twin and a library yardstick."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import adaln_linear as AL
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear, adaln_linear_plain
    from mdgen_finetune_tpu_torch.ops.ipa_attention import feat_width, proj_width
    from mdgen_finetune_tpu_torch.ops import rope_attention as RA
    from mdgen_finetune_tpu_torch.ops.rope_attention import (rope_attention, rope_attention_math,
                                                             rope_attention_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    M = B * T * L

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(dtype)

    def f(t):
        return None if t is None else t.float()

    out = {}
    # ---- adaln_linear: every use on the main path, each on the route its plan takes ----
    x, res = r(M, C), r(M, C)
    sh, scl, gate = r(B, C, sc=0.3), r(B, C, sc=0.3), r(B, C, sc=0.3)
    carry = r(M, 21, dtype=f32)
    fin_mods = r(B, NL * 9 * C + 2 * C, sc=0.3)[:, NL * 9 * C:]
    pw, fw = proj_width(4, 32, 8, 8), feat_width(4, 32, 8)
    uses = {  # name: (x, w, b, kwargs, route: 0 resident, 1 pipelined, 2 tiled64)
        "qkv": (x, r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), dict(ln="plain", shift=sh, scale=scl), 0),
        "out_gate": (x, r(C, C, sc=C ** -0.5), r(C, sc=0.1), dict(epilogue="gate_res", res=res, gate=gate), 0),
        "fc1_gelu": (x, r(C, 4 * C, sc=C ** -0.5), r(4 * C, sc=0.1),
                     dict(ln="plain", shift=sh, scale=scl, epilogue="gelu"), 0),
        "fc2_gate": (r(M, 4 * C), r(4 * C, C, sc=(4 * C) ** -0.5), r(C, sc=0.1),
                     dict(epilogue="gate_res", res=res, gate=gate), 1),
        "head_euler": (x, r(C, 21, sc=C ** -0.5), r(21, sc=0.1),
                       dict(ln="plain", shift=sh[:1], scale=scl[:1], epilogue="euler", res=carry, dt=0.01), 2),
        # the design preset's FinalLayer, unfolded from the trunk (C -> 48,
        # each element's shift / scale: views into its AdaLN rows)
        "final_no_epilogue": (x, r(C, 48, sc=C ** -0.5), r(48, sc=0.1),
                              dict(ln="plain", shift=fin_mods[:, :C], scale=fin_mods[:, C:]), 2),
        "embed_add": (r(M, 21, dtype=f32), r(21, C, sc=0.2), None,
                      dict(epilogue="add", add1=r(M, C), add2=r(B * L, C), add2_map=(T * L, L, L)), 2),
        "ipa_proj_affine": (x, r(C, pw, sc=C ** -0.5), r(pw, sc=0.1),
                            dict(ln="affine", ln_weight=1 + r(C, sc=0.1, dtype=f32),
                                 ln_bias=r(C, sc=0.1, dtype=f32), out_dtype=f32), 0),
        "ipa_out": (r(M, fw), r(fw, C, sc=0.06), r(C, sc=0.1), dict(epilogue="gate_res", res=res), 0),
    }

    def library(a, w, b, kw):
        """The same function as one chain of PyTorch calls: LayerNorm and
        modulate in f32, addmm in bf16, the epilogue."""
        Kd = w.shape[0]
        h = a.float()
        if kw.get("ln") == "plain":
            h = F.layer_norm(h, (Kd,), eps=1e-6)
        elif kw.get("ln") == "affine":
            h = F.layer_norm(h, (Kd,), kw["ln_weight"], kw["ln_bias"], eps=1e-5)
        if kw.get("shift") is not None:
            rows = M // kw["shift"].shape[0]
            h = h * (1 + kw["scale"].float().repeat_interleave(rows, 0)) \
                + kw["shift"].float().repeat_interleave(rows, 0)
        h = h.to(bf)
        y = torch.mm(h, w) if b is None else torch.addmm(b, h, w)
        epi = kw.get("epilogue", "none")
        if epi == "gelu":
            return F.gelu(y)
        if epi == "gate_res":
            g_ = kw.get("gate")
            return kw["res"] + (y if g_ is None else g_.repeat_interleave(M // g_.shape[0], 0) * y)
        if epi == "euler":
            return kw["res"] + kw["dt"] * y.float()
        if epi == "add":
            div, mul, mod = kw["add2_map"]
            idx = torch.arange(M, device=dev)
            return y + kw["add1"] + kw["add2"][(idx // div) * mul + idx % mod]
        return y.float() if kw.get("out_dtype") == f32 else y

    errs, use_out = {}, {}
    for name, (a, w, b, kw, route) in uses.items():
        p = AL.plan(a, w, b, **kw)
        if p.route != route:
            raise AssertionError(f"adaln_linear[{name}]: route {p.name}, expected "
                                 f"{AL.ROUTES[route]} (plan {p})")
        got = adaln_linear(a, w, b, **kw)
        kwf = {k: (f(v) if torch.is_tensor(v) and v.dtype == bf else v) for k, v in kw.items()}
        ref = adaln_linear_plain(a.float(), w.float(), f(b), **kwf)
        errs[name] = check(f"adaln_linear[{name}]", got, ref, 1e-2)
        run = lambda: adaln_linear(a, w, b, **kw)  # noqa: E731
        Kd, Nd = w.shape
        obytes = M * Nd * (4 if got.dtype == f32 else 2)
        ins = [t for t in (a, w, b, kw.get("shift"), kw.get("scale"), kw.get("gate"), kw.get("res"),
                           kw.get("add1"), kw.get("add2"), kw.get("ln_weight"), kw.get("ln_bias"))
               if t is not None]
        use_out[name] = dict(
            route=p.name, shape=f"({M},{Kd}) @ ({Kd},{Nd})", plan=dataclasses.asdict(p),
            max_abs_err=errs[name][0], tol=errs[name][1],
            ms=time_ms(run), back_to_back_ms=back_to_back_ms(run),
            parent=parent_times("adaln_linear", run),
            library_ms=time_ms(lambda: library(a, w, b, kw)),
            bare_mm_ms=time_ms(lambda: torch.mm(a.to(bf), w)),
            bound=bound_ms(nbytes(*ins) + obytes, 2.0 * M * Kd * Nd),
            resources=AL.resources(p, got.dtype == f32, kw.get("epilogue", "none"))
            if p.route < 2 else None)
        del got, ref
    a, w, b, kw, _ = uses["fc1_gelu"]
    fc1 = use_out["fc1_gelu"]
    out["adaln_linear"] = dict(
        shape=f"fc1: LN+modulate, {fc1['shape']}, GELU; every main-path use in uses",
        uses=use_out, max_abs_err=max(e for e, _ in errs.values()),
        tol={k: t for k, (_, t) in errs.items()},
        ms=fc1["ms"], back_to_back_ms=fc1["back_to_back_ms"], parent=fc1["parent"],
        plain_ms=time_ms(lambda: adaln_linear_plain(a, w, b, **kw)),
        library_ms=fc1["library_ms"], bare_mm_ms=fc1["bare_mm_ms"], bound=fc1["bound"],
        resources=fc1["resources"])

    # ---- rope_attention: stage 1, stage 2 (base 2) and the encoder MHA ----
    mask = torch.ones(B, T, L, device=dev)
    mask[0, :, -1] = 0
    qkv = r(B, T, L, 3 * C)
    bk, bv = r(C), r(C)
    errs = {}
    for name, view, mk, base2 in (("stage1", (B * T, L, 1, 3 * C), (B * T, L, 1), True),
                                  ("stage2", (B, T, L, 3 * C), (B, T, L), True),
                                  ("encoder_mha", (B * T, L, 1, 3 * C), (B * T, L, 1), False)):
        q = qkv.view(view)
        got = rope_attention(q, bk, bv, mask.view(mk), num_heads=H, base2=base2)
        ref = rope_attention_plain(q.float(), bk.float(), bv.float(), mask.view(mk),
                                   num_heads=H, base2=base2)
        errs[name] = check(f"rope_attention[{name}]", got, ref, 1e-2)
    # what rounding the RoPE'd q and k to bf16 (the JAX kernel's staging)
    # would cost at stage 2's inputs, against the f32 twin: the reason the
    # long body stages them in fp16
    ref = rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask, num_heads=H, base2=True)
    emu = rope_attention_math(qkv.float(), bk.float(), bv.float(), mask, num_heads=H, base2=True,
                              stage=torch.bfloat16)
    bf16_stage = (emu - ref).abs().max().item() / (1e-2 * max(1.0, ref.abs().max().item()))
    del ref, emu
    run = lambda: rope_attention(qkv, bk, bv, mask, num_heads=H, base2=True)  # noqa: E731
    plain = lambda: rope_attention_plain(qkv, bk, bv, mask, num_heads=H, base2=True)  # noqa: E731
    # library yardstick: SDPA on the same (pre-roped, bias-appended) heads
    S, D = B * L, C // H
    qh = qkv[..., :C].permute(0, 2, 1, 3).reshape(S, T, H, D).transpose(1, 2).contiguous()
    kh = torch.cat([qkv[..., C:2 * C].permute(0, 2, 1, 3).reshape(S, T, H, D),
                    bk.view(1, 1, H, D).expand(S, 1, H, D)], 1).transpose(1, 2).contiguous()
    vh = torch.cat([qkv[..., 2 * C:].permute(0, 2, 1, 3).reshape(S, T, H, D),
                    bv.view(1, 1, H, D).expand(S, 1, H, D)], 1).transpose(1, 2).contiguous()
    am = torch.cat([mask.permute(0, 2, 1).reshape(S, T), torch.ones(S, 1, device=dev)], 1) > 0
    am = am[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)  # noqa: E731
    n_seq = B * L
    flops = 4.0 * n_seq * H * T * (T + 1) * D
    out["rope_attention"] = dict(
        shape=f"stage 2: {n_seq} sequences x {H} heads, {T} queries, {T + 1} keys, D={D}",
        max_abs_err=max(e for e, _ in errs.values()), tol={k: t for k, (_, t) in errs.items()},
        ms=time_ms(run), plain_ms=time_ms(plain), library_ms=time_ms(lib),
        back_to_back_ms=back_to_back_ms(run), library_back_to_back_ms=back_to_back_ms(lib),
        stage1_ms=time_ms(lambda: rope_attention(qkv.view(B * T, L, 1, 3 * C), bk, bv,
                                                 mask.view(B * T, L, 1), num_heads=H, base2=True)),
        bound=bound_ms(nbytes(qkv, bk, bv, mask) + B * T * L * C * 2, flops),
        resources=RA.resources(T, H, C), bf16_staging_err_of_tol=bf16_stage)

    # ---- ipa_attention: the encoder over the whole t grid (S*B elements) ----
    def pad_every_7th(m):
        m[::7, -1] = 0

    out["ipa_attention"] = ipa_entry(dev, "encoder", STEPS * B, L, (32, 8, 8), pad_every_7th,
                                     seed=0)
    out["tiled_attention"], stages = long_t_kernels(dev)
    emit({"phase": "kernels", "kernels": out, "stages_1000": stages})
    return out


def sdpa_inputs(qkv, bk, bv, mask, Hc):
    """For a library yardstick of the trunk's attention over (G, N, I, 3C)
    qkv: the RoPE'd heads with the bias key, and the additive key mask."""
    from mdgen_finetune_tpu_torch.models.rope import apply_rope

    Bc, N, Lc, C3 = qkv.shape
    Cc, S = C3 // 3, Bc * Lc
    D = Cc // Hc

    def heads(t, extra=None):
        t = t.permute(0, 2, 1, 3).reshape(S, N, Hc, D)
        if extra is not None:
            t = torch.cat([t, extra.view(1, 1, Hc, D).expand(S, 1, Hc, D)], 1)
        return t.transpose(1, 2)

    q, k = apply_rope(heads(qkv[..., :Cc]), heads(qkv[..., Cc:2 * Cc], bk))
    v = heads(qkv[..., 2 * Cc:], bv)
    valid = torch.cat([mask.permute(0, 2, 1).reshape(S, N), torch.ones(S, 1, device=qkv.device)], 1)
    am = ((valid - 1.0) * 1e9).to(qkv.dtype)[:, None, None, :]
    return q.contiguous(), k.contiguous(), v.contiguous(), am


GENERAL = "MDGEN_SHORT_GENERAL"  # rope_attention's short body without its contiguous path


def phase_rope_short(dev):
    """The streaming short body of ``rope_attention`` (N <= 16) at its three
    uses on the main paths, (G, N, I) = (B*T, L, 1) = (6400, 4, 1): trunk
    stage 1 (base 2), the modular layer's residue attention (TPU row 12,
    natural) and the encoder's residue MHA (natural, G = B = 64), with a
    padded residue and a frame whose only valid key is the bias token; each
    against its f32 plain twin (1e-2 x max(1, max |twin|)), by events and
    back to back, the parent's sources on the same inputs (with
    MDGEN_PARENT_CSRC; ``bits_equal_parent``), SDPA on the same pre-RoPE'd
    inputs (``sdpa_inputs``), the bound and the resources with the plan;
    at stage 1 also the build without the contiguous copy path
    (``-DMDGEN_SHORT_GENERAL``: every unit through the general row
    arithmetic), its bits and times. Also the streaming short body of
    ``rope_attention_bwd`` at its three uses (the training path's stage 1,
    (3200, 4, 1); the T = 1000 training's, (8000, 4, 1); the merged route's
    residue stage at B = 4, T = 200, (800, 4, 1)), with a padded residue and
    a frame whose only valid key is the bias token: against its f32 plain
    twin, by events, back to back, the host's time, the parent's sources
    (dqkv and both bias gradients bit for bit, asserted), the bound, the
    resources with the plan, and at stage 1 SDPA's backward on the same
    pre-RoPE'd heads."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.ops import rope_attention as RA
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    g = torch.Generator(device=dev).manual_seed(71)
    D = C // H
    out = {}
    for name, Gc, base2 in (("stage1_base2", B * T, True), ("row12_natural", B * T, False),
                            ("encoder_mha", B, False)):
        qkv = torch.randn(Gc, L, 1, 3 * C, generator=g, device=dev)
        qkv[..., :C] *= D ** -0.5 * (1.4427 if base2 else 1.0)  # q carries its scale
        qkv = qkv.bfloat16()
        bk, bv = (torch.randn(C, generator=g, device=dev) * 0.4).bfloat16(), \
            (torch.randn(C, generator=g, device=dev) * 0.4).bfloat16()
        mask = torch.ones(Gc, L, 1, device=dev)
        mask[:Gc // 2, -1] = 0  # a padded residue in half of the frames
        mask[1] = 0  # a frame whose only valid key is the bias token
        kw = dict(num_heads=H, base2=base2)
        got = RA.rope_attention(qkv, bk, bv, mask, **kw)
        ref = RA.rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask, **kw)
        err = check(f"rope_short[{name}]", got, ref, 1e-2)
        if not torch.equal(got[1], bv.view(1, 1, C).expand_as(got[1])):
            raise AssertionError(f"rope_short[{name}]: a frame with only the bias key valid "
                                 "did not give the bias value")
        bits = None
        if parent_lib("rope_attention") is not None:
            with with_parent(("rope_attention",)):
                bits = torch.equal(RA.rope_attention(qkv, bk, bv, mask, **kw), got)
        run = lambda: RA.rope_attention(qkv, bk, bv, mask, **kw)  # noqa: E731
        general = None
        if name == "stage1_base2":
            with with_libs({"rope_attention": _cuda.variant_library("rope_attention", GENERAL)}):
                general = dict(bits_equal=torch.equal(run(), got), ms=time_ms(run),
                               back_to_back_ms=back_to_back_ms(run))
            if not general["bits_equal"]:
                raise AssertionError("rope_short: the general copy path moved the bits")
        q, k, v, am = sdpa_inputs(qkv, bk, bv, mask, H)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)  # noqa: E731
        out[name] = dict(
            shape=f"(G, N, I) = ({Gc}, {L}, 1), {H} heads of D = {D}, "
                  f"{'base 2' if base2 else 'natural'}",
            max_abs_err=err[0], tol=err[1], ms=time_ms(run), back_to_back_ms=back_to_back_ms(run),
            parent=parent_times("rope_attention", run), bits_equal_parent=bits,
            plain_ms=time_ms(lambda: RA.rope_attention_plain(qkv, bk, bv, mask, **kw)),
            library_ms=time_ms(lib), library_back_to_back_ms=back_to_back_ms(lib),
            bound=bound_ms(nbytes(qkv, bk, bv, mask, got), 4.0 * Gc * H * L * (L + 1) * D),
            resources=RA.resources(L, H, C, G=Gc), general_path=general)
        del qkv, got, ref, q, k, v, am
    # the short backward (rope_attention_bwd, N = 4) at its three uses: the
    # training path's stage 1, the T = 1000 training's, the merged route's
    # residue stage at B = 4, T = 200 (on the split route here: the same body)
    for name, Gb in (("bwd_stage1", B_TRAIN * T), ("bwd_t1000", B_SIM * T_SIM),
                     ("bwd_merged_p11", 4 * 200)):
        qkv = (torch.randn(Gb, L, 1, 3 * C, generator=g, device=dev) * 0.5).bfloat16()
        do = (torch.randn(Gb, L, 1, C, generator=g, device=dev) * 0.1).bfloat16()
        bk, bv = (torch.randn(C, generator=g, device=dev) * 0.4).bfloat16(), \
            (torch.randn(C, generator=g, device=dev) * 0.4).bfloat16()
        mask = torch.ones(Gb, L, 1, device=dev)
        mask[:Gb // 32, -1] = 0
        mask[1] = 0  # a frame whose only valid key is the bias token
        got = RB.rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=H)
        ref = RB.rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                          num_heads=H)
        errs = [check(f"rope_short[{name} {i}]", a, b, 1e-2) for i, (a, b) in enumerate(zip(got, ref))]
        if got[0][1, :, :, C:].any():
            raise AssertionError(f"rope_short[{name}]: masked keys have a gradient")
        bits = None
        if parent_lib("rope_attention_bwd") is not None:
            with with_parent(("rope_attention_bwd",)):
                bits = [torch.equal(a, b) for a, b in
                        zip(RB.rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=H), got)]
            if not all(bits):
                raise AssertionError(f"rope_short[{name}]: dqkv, dbk, dbv moved from the parent's "
                                     f"bits: {bits}")
        run = lambda: RB.rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=H)  # noqa: E731
        entry = dict(
            shape=f"(G, N, I) = ({Gb}, {L}, 1), {H} heads of D = {D}",
            max_abs_err=max(e for e, _ in errs), tol=max(t for _, t in errs), ms=time_ms(run),
            back_to_back_ms=back_to_back_ms(run), host_ms=host_ms(run),
            parent=parent_times("rope_attention_bwd", run), bits_equal_parent=bits,
            plain_ms=time_ms(lambda: RB.rope_attention_bwd_plain(qkv, do, bk, bv, mask,
                                                                 num_heads=H), reps=5),
            library_ms=None,
            bound=bound_ms(nbytes(qkv, do, bk, bv, mask, *got), 10.0 * Gb * H * L * (L + 1) * D),
            resources=RB.resources(L, H, C, G=Gb))
        if name == "bwd_stage1":
            # library yardstick: SDPA's backward on the same RoPE'd, bias-appended heads
            q, k, v, am = sdpa_inputs(qkv, bk, bv, mask, H)
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
            go = do.permute(0, 2, 1, 3).reshape(Gb, L, H, D).transpose(1, 2).contiguous()
            lib = lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True)  # noqa: E731
            entry.update(shape=entry["shape"] + " (the training path's stage 1)",
                         library_ms=time_ms(lib), library_back_to_back_ms=back_to_back_ms(lib))
            del q, k, v, o, go
        out[name] = entry
        del qkv, do, got, ref
    emit({"phase": "rope_short", "kernels": out})
    return out


def long_t_kernels(dev):
    """The kernels of the 4AA forward-simulation preset (T = 1000): the
    key-tiled frame-attention core against its plain twin at the path's
    shape (B = 8, L = 4, 16 heads of D = 24, some frames masked) and at
    N = 2048, D = 64; the trunk's three stage ops (rows 9, 6 and 5 of the
    TPU kernel table) against their plain compositions at B = 1 and 8."""
    import math

    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import adaln_mlp as AM
    from mdgen_finetune_tpu_torch.ops import residue_block as RB
    from mdgen_finetune_tpu_torch.ops import time_attention as TA
    from mdgen_finetune_tpu_torch.ops import tiled_attention as TLA
    from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention, tiled_attention_plain

    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def r(*s, sc=1.0):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(bf)

    def attn_case(Bc, N, Lc, Hc, D):
        Cc = Hc * D
        qkv = r(Bc, N, Lc, 3 * Cc)
        qkv[..., :Cc] *= 0.5 * D ** -0.5 * math.log2(math.e)  # the trunk's folded q scale
        mask = torch.ones(Bc, N, Lc, device=dev)
        mask[0, N // 2:, -1] = 0   # masked frames
        mask[-1, 64:128] = 0       # a key tile of masked keys only
        return qkv, r(Cc), r(Cc), mask, Hc

    res = {}
    for name, shape in (("4aa_T1000", (B_SIM, T_SIM, L, H, C // H)), ("n2048_d64", (4, 2048, 1, 6, 64))):
        qkv, bk, bv, mask, Hc = attn_case(*shape)
        got = tiled_attention(qkv, bk, bv, mask, num_heads=Hc)
        ref = tiled_attention_plain(qkv.float(), bk.float(), bv.float(), mask, num_heads=Hc)
        err = check(f"tiled_attention[{name}]", got, ref, 1e-2)
        del ref
        q, k, v, am = sdpa_inputs(qkv, bk, bv, mask, Hc)
        Bc, N, Lc, C3 = qkv.shape
        D = C3 // 3 // Hc
        # SDPA's natural-exp softmax at scale ln 2 is the base-2 softmax of q.k
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=math.log(2))  # noqa: E731
        run = lambda: tiled_attention(qkv, bk, bv, mask, num_heads=Hc)  # noqa: E731
        res[name] = dict(
            shape=f"{Bc * Lc} sequences x {Hc} heads, {N} queries, {N + 1} keys, D={D}",
            max_abs_err=err[0], tol=err[1], ms=time_ms(run),
            plain_ms=time_ms(lambda: tiled_attention_plain(qkv, bk, bv, mask, num_heads=Hc), reps=5),
            library_ms=time_ms(lib), library_back_to_back_ms=back_to_back_ms(lib),
            bound=bound_ms(nbytes(qkv, bk, bv, mask) + qkv.numel() // 3 * 2,
                           4.0 * Bc * Lc * Hc * N * (N + 1) * D),
            **long_key_times("tiled_attention", run, Bc * Lc * Hc * N * (N + 1),
                             TLA.resources(Bc, N, Lc, Hc, D)))
        del q, k, v, am, qkv
    tiled = dict(res["4aa_T1000"], n2048_d64=res["n2048_d64"])

    # the trunk's stage ops at T = 1000 against their plain compositions (f32)
    stages = {}
    for Bc in (1, B_SIM):
        M = Bc * T_SIM * L
        mask = torch.ones(Bc, T_SIM, L, device=dev)
        mask[0, :, -1] = 0
        mask[-1, 900:] = 0
        x = r(M, C)
        mods = [r(Bc, C, sc=0.3) for _ in range(3)]
        attn_ws = [r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), r(C, C, sc=C ** -0.5),
                   r(C, sc=0.1), r(C), r(C)]
        mlp_ws = [r(C, 4 * C, sc=C ** -0.5), r(4 * C, sc=0.1), r(4 * C, C, sc=(4 * C) ** -0.5),
                  r(C, sc=0.1)]
        dims = dict(B=Bc, T=T_SIM, L=L, num_heads=H)
        f_att = 4.0 * Bc * L * H * T_SIM * (T_SIM + 1) * (C // H)
        ops = {  # name: (op, plain, weights, dims, FLOP, the long-key kernel inside)
            "row9_residue_block": (RB.residue_block, RB.residue_block_plain, attn_ws + [mask], dims,
                                   2.0 * M * C * 4 * C + 4.0 * M * (L + 1) * C, None),
            "row6_time_attention_block": (TA.time_attention_block, TA.time_attention_block_plain,
                                          attn_ws + [mask], dims, 2.0 * M * C * 4 * C + f_att,
                                          "tiled_attention"),
            "row5_adaln_mlp": (AM.adaln_mlp, AM.adaln_mlp_plain, mlp_ws, {}, 16.0 * M * C * C,
                               None),
        }
        for name, (op, plain, ws, kw, flops, core) in ops.items():
            # a composition of kernels, held as the trunk rows are: its error
            # against the plain twins in f32 at most twice that of the plain
            # twins in bf16, plus 0.01 (relative L2)
            got = op(x, *mods, *ws, **kw).float()
            ref = plain(x.float(), *[m.float() for m in mods], *[w.float() for w in ws], **kw)
            rel = ((got - ref).norm() / ref.norm()).item()
            rel_plain = ((plain(x, *mods, *ws, **kw).float() - ref).norm() / ref.norm()).item()
            err = (got - ref).abs().max().item()
            del got, ref
            if not (rel <= 2 * rel_plain + 0.01) or err != err:
                raise AssertionError(f"{name}[B={Bc}]: relative L2 {rel} > 2 x {rel_plain} + 0.01")
            stages[f"{name}_B{Bc}"] = dict(
                rel_l2=rel, tol=2 * rel_plain + 0.01, max_abs_err=err,
                ms=time_ms(lambda: op(x, *mods, *ws, **kw)),
                parent=parent_times(core, lambda: op(x, *mods, *ws, **kw)) if core else None,
                plain_ms=time_ms(lambda: plain(x, *mods, *ws, **kw), reps=5),
                bound=bound_ms(nbytes(x, *mods, *ws) + M * C * 2, flops))
    return tiled, stages


def phase_bwd_kernels(dev):
    """The training backward kernels against their plain twins (f32 on the
    same inputs) at the training path's shapes (B = 32: M = 12,800 rows);
    times of kernel, twin and a library yardstick."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops.linear_bwd import linear_bwd, linear_bwd_plain
    from mdgen_finetune_tpu_torch.ops.modln_bwd import modln_bwd, modln_bwd_plain
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RBM
    from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import (
        rope_attention_bwd, rope_attention_bwd_plain)

    g = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    Bt = B_TRAIN
    M = Bt * T * L

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(dtype)

    def f(kw):
        return {k: (v.float() if torch.is_tensor(v) and v.dtype == bf else v) for k, v in kw.items()}

    out = {}
    # ---- linear_bwd: dgrad and wgrad at the fc1/fc2 and qkv shapes ----
    from mdgen_finetune_tpu_torch.models.layers import gelu_fast_with_grad
    from mdgen_finetune_tpu_torch.ops import linear_bwd as LB

    x, dout = r(M, C), r(M, C, dtype=f32)
    sh, scl, gate = r(Bt, C, sc=0.3), r(Bt, C, sc=0.3), r(Bt, C, sc=0.3)
    da, dqkv = r(M, 4 * C, sc=0.1), r(M, 3 * C, sc=0.1)
    uses = {
        "fc1_wgrad": ("wgrad", da, x, dict(ln=True, shift=sh, scale=scl)),
        "fc1_dgrad": ("dgrad", da, r(C, 4 * C, sc=C ** -0.5), {}),
        "fc2_wgrad": ("wgrad", dout, r(M, 4 * C), dict(gate=gate)),
        "fc2_dgrad_gelu": ("dgrad", dout, r(4 * C, C, sc=(4 * C) ** -0.5),
                           dict(gate=gate, act=r(M, 4 * C, sc=2.0, dtype=f32), out_dtype=bf)),
        "qkv_wgrad": ("wgrad", dqkv, x, dict(ln=True, shift=sh, scale=scl)),
        "qkv_dgrad": ("dgrad", dqkv, r(C, 3 * C, sc=C ** -0.5), {}),
    }
    rows = lambda v: v.float().repeat_interleave(T * L, 0)  # noqa: E731

    def prologued(mode, dy, xx, kw):
        """The bf16 operands of the product itself: P(dY), and P(A) or W."""
        g = (dy.float() * rows(kw["gate"]) if "gate" in kw else dy).to(bf)
        if mode == "wgrad" and kw.get("ln"):
            xx = (F.layer_norm(xx.float(), (xx.shape[1],), eps=1e-6) * (1 + rows(kw["scale"]))
                  + rows(kw["shift"])).to(bf)
        return g, xx

    def library(mode, dy, xx, kw):
        """The same function in PyTorch calls: the prologue, torch.mm on the
        bf16 operands, the GELU' epilogue / the column sum."""
        g, a = prologued(mode, dy, xx, kw)
        if mode == "dgrad":
            o = torch.mm(g, a.t())
            if "act" in kw:
                o = o.float() * gelu_fast_with_grad(kw["act"])[1]
            return o
        return torch.mm(a.t(), g), g.float().sum(0)

    errs, use = {}, {}
    for name, (mode, dy, xx, kw) in uses.items():
        got = linear_bwd(mode, dy, xx, **kw)
        ref = linear_bwd_plain(mode, dy.float(), xx.float(), **f(kw))
        if mode == "wgrad":
            e1, t1 = check(f"linear_bwd[{name}].dW", got[0], ref[0], 1e-2)
            e2, _ = check(f"linear_bwd[{name}].db", got[1], ref[1], 1e-2)
            errs[name] = (max(e1, e2), t1)
        else:
            errs[name] = check(f"linear_bwd[{name}]", got, ref, 1e-2)
        again = linear_bwd(mode, dy, xx, **kw)  # two calls, the same bits
        if not all(torch.equal(a, b) for a, b in zip(got if mode == "wgrad" else (got,),
                                                     again if mode == "wgrad" else (again,))):
            raise AssertionError(f"linear_bwd[{name}]: two calls differ")
        del ref, got, again
        run = lambda: linear_bwd(mode, dy, xx, **kw)  # noqa: E731
        pg, pa = prologued(mode, dy, xx, kw)
        bare = (lambda: torch.mm(pg, pa.t())) if mode == "dgrad" else (lambda: torch.mm(pa.t(), pg))
        Mi, Ni = dy.shape
        Ki = xx.shape[0] if mode == "dgrad" else xx.shape[1]
        outb = Mi * Ki * (4 if kw.get("out_dtype") is None else 2) if mode == "dgrad" \
            else (Ki * Ni + Ni) * 4
        use[name] = dict(
            shape=f"{mode}: M={Mi}, N={Ni}, K={Ki}" + "".join(f", {k}" for k in kw
                                                              if k != "out_dtype"),
            ms=time_ms(run), back_to_back_ms=back_to_back_ms(run),
            parent=parent_times("linear_bwd", run),
            library_ms=time_ms(lambda: library(mode, dy, xx, kw)),
            bare_mm_ms=time_ms(bare), bare_mm_back_to_back_ms=back_to_back_ms(bare),
            bound=bound_ms(nbytes(dy, xx, *(v for v in kw.values() if torch.is_tensor(v)))
                           + outb, 2.0 * Mi * Ni * Ki))
        del pg, pa
    mode, dy, xx, kw = uses["fc1_wgrad"]
    K_, N_ = C, 4 * C
    out["linear_bwd"] = dict(
        shape=f"fc1 wgrad: LN+modulate({M},{K_})^T @ ({M},{N_}), f32 sum over {M} rows",
        uses=use, max_abs_err=max(e for e, _ in errs.values()),
        tol={k: t for k, (_, t) in errs.items()}, ms=use["fc1_wgrad"]["ms"],
        back_to_back_ms=use["fc1_wgrad"]["back_to_back_ms"], parent=use["fc1_wgrad"]["parent"],
        plain_ms=time_ms(lambda: linear_bwd_plain(mode, dy, xx, **kw)),
        library_ms=use["fc1_wgrad"]["library_ms"], bare_mm_ms=use["fc1_wgrad"]["bare_mm_ms"],
        bound=use["fc1_wgrad"]["bound"],
        resources={m: LB.resources(m) for m in ("dgrad", "wgrad")},
        splits={k: LB._splits(v[1].shape[0], *((v[2].shape[0], v[1].shape[1]) if v[0] == "dgrad"
                                                else (v[2].shape[1], v[1].shape[1])))
                for k, v in uses.items() if v[0] == "wgrad"})

    # ---- modln_bwd (row e) at the three training shapes: the flagship's
    # (M, C) over B elements, T = 1000's and ATLAS's ----
    from mdgen_finetune_tpu_torch.ops import modln_bwd as MBM
    from mdgen_finetune_tpu_torch.tools import form_clock as FC

    shapes = {}
    for name, Ms, nbs in FC.MODLN_SHAPES:
        xm, dh, dm, y, sm = FC.modln_inputs(Ms, nbs)
        run = lambda: modln_bwd(xm, dh, dm, y, sm)  # noqa: E731
        n0 = modln_bwd.launches
        got = run()
        if modln_bwd.launches != n0 + 1:
            raise AssertionError("modln_bwd: the wrapper did not count its launch")
        ref = modln_bwd_plain(xm.float(), dh, dm, y, sm.float())
        e1 = check(f"modln_bwd[{name}].dx", got[0], ref[0], 1e-3)
        e2 = check(f"modln_bwd[{name}].dmod", got[1], ref[1], 1e-3)
        del ref
        again = run()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"modln_bwd[{name}]: two calls differ")
        bits_parent = None
        if parent_lib("modln_bwd") is not None:
            with with_parent(("modln_bwd",)):
                before = run()
            torch.cuda.synchronize()
            bits_parent = all(torch.equal(a, b) for a, b in zip(got, before))
            if not bits_parent:
                raise AssertionError(f"modln_bwd[{name}]: the parent's bits differ")
            del before
        # the launches a call from a CUDA graph of one call; the profiler's
        # count, where a trace comes back whole, must agree
        launches = FC.kernel_nodes(run)
        if launches != {"modln_bwd": 1, "colsum": 1}:
            raise AssertionError(f"modln_bwd[{name}]: want the kernel and the split sum, "
                                 f"one launch each a call; the graph holds {launches}")
        try:
            by_kernel, traced = FC.kernel_ms(run)
        except FC.TraceGap as gap:
            by_kernel, traced = f"not measured: {gap}", launches
        if traced != launches:
            raise AssertionError(f"modln_bwd[{name}]: the trace holds {traced} a call, "
                                 f"the graph {launches}")
        xl = xm.float().requires_grad_()
        hl = F.layer_norm(xl, (C,), eps=1e-6) * (1 + sm.float().repeat_interleave(Ms // nbs, 0))
        shapes[name] = dict(
            shape=f"({Ms},{C}) rows, {nbs} elements", splits=MBM.plan(Ms, nbs)[0],
            max_abs_err=max(e1[0], e2[0]), tol={"dx": e1[1], "dmod": e2[1]},
            ms=time_ms(run), back_to_back_ms=back_to_back_ms(run), host_ms=host_ms(run),
            parent=parent_times("modln_bwd", run), bits_equal_parent=bits_parent,
            plain_ms=time_ms(lambda: modln_bwd_plain(xm, dh, dm, y, sm)),
            library_ms=time_ms(lambda: torch.autograd.grad(hl, xl, dh, retain_graph=True)),
            bound=bound_ms(nbytes(xm, dh, dm, y, sm) + Ms * C * 4 + nbs * 3 * C * 4,
                           20.0 * Ms * C),
            kernel_ms=by_kernel, launches_per_call=sum(launches.values()))
        del xm, dh, dm, y, sm, got, again, xl, hl
    out["modln_bwd"] = dict(shapes["flagship (train_path)"], shapes=shapes,
                            resources=MBM.resources(C))

    # ---- rope_attention_bwd: stage 1 and stage 2 ----
    mask = torch.ones(Bt, T, L, device=dev)
    mask[0, :, -1] = 0
    qkv = r(Bt, T, L, 3 * C)
    bk, bv = r(C), r(C)
    do = r(Bt, T, L, C)
    errs = {}
    for name, view in (("stage1", (Bt * T, L, 1)), ("stage2", (Bt, T, L))):
        q, dd, mk = qkv.view(*view, 3 * C), do.view(*view, C), mask.view(view)
        got = rope_attention_bwd(q, dd, bk, bv, mk, num_heads=H)
        ref = rope_attention_bwd_plain(q.float(), dd.float(), bk.float(), bv.float(), mk,
                                       num_heads=H)
        es = [check(f"rope_attention_bwd[{name}][{i}]", a, b, 1e-2) for i, (a, b) in
              enumerate(zip(got, ref))]
        errs[name] = (max(e for e, _ in es), es[0][1])
    # the bf16 staging of the RoPE'd q and k (JAX's rounding point), alone,
    # against the f32 twin at stage 2's inputs: the worst of dqkv, dbk, dbv
    ref = rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                   num_heads=H)
    emu = RBM.rope_attention_bwd_math(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                      num_heads=H, stage=torch.bfloat16)
    bf16_stage = max((a.float() - b).abs().max().item() / (1e-2 * max(1.0, b.abs().max().item()))
                     for a, b in zip(emu, ref))
    del ref, emu
    run = lambda: rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=H)  # noqa: E731
    plain = lambda: rope_attention_bwd_plain(qkv, do, bk, bv, mask, num_heads=H)  # noqa: E731
    # library yardstick: SDPA's backward on the same (pre-roped, bias-appended) heads
    S, D = Bt * L, C // H

    def heads(t, extra=None):
        t = t.permute(0, 2, 1, 3).reshape(S, T, H, D)
        if extra is not None:
            t = torch.cat([t, extra.view(1, 1, H, D).expand(S, 1, H, D)], 1)
        return t.transpose(1, 2).contiguous().requires_grad_()

    qh, kh, vh = heads(qkv[..., :C]), heads(qkv[..., C:2 * C], bk), heads(qkv[..., 2 * C:], bv)
    am = torch.cat([mask.permute(0, 2, 1).reshape(S, T), torch.ones(S, 1, device=dev)], 1) > 0
    o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am[:, None, None, :])
    go = do.permute(0, 2, 1, 3).reshape(S, T, H, D).transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(o, (qh, kh, vh), go, retain_graph=True)  # noqa: E731
    n_seq = Bt * L
    out["rope_attention_bwd"] = dict(
        shape=f"stage 2: {n_seq} sequences x {H} heads, {T} queries, {T + 1} keys, D={D}",
        max_abs_err=max(e for e, _ in errs.values()), tol={k: t for k, (_, t) in errs.items()},
        ms=time_ms(run), plain_ms=time_ms(plain), library_ms=time_ms(lib),
        back_to_back_ms=back_to_back_ms(run), library_back_to_back_ms=back_to_back_ms(lib),
        parent=parent_times("rope_attention_bwd", run),
        stage1_ms=time_ms(lambda: rope_attention_bwd(qkv.view(Bt * T, L, 1, 3 * C),
                                                     do.view(Bt * T, L, 1, C), bk, bv,
                                                     mask.view(Bt * T, L, 1), num_heads=H)),
        bound=bound_ms(nbytes(qkv, do, bk, bv, mask) + qkv.numel() * 2 + 2 * C * 4,
                       10.0 * n_seq * H * T * (T + 1) * D),
        resources=RBM.resources(T, H, C), bf16_staging_err_of_tol=bf16_stage)
    emit({"phase": "bwd_kernels", "kernels": out})
    return out


def train_config(batch_size):
    from mdgen_finetune_tpu_torch.config import (DataConfig, MDGenConfig, ModelConfig,
                                                 TaskConfig, TrainConfig)

    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        data=DataConfig(data_dir=str(SCRATCH / "data"), num_frames=T, crop=L),
        task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=batch_size, lr=1e-4, grad_clip=1.0, ema=True,
                          ema_decay=0.999),
        workdir=str(SCRATCH), run_name="train")


def phase_grad_across_devices(dev, cfg=None, phase="grad_cuda_vs_cpu", pad=1, extra=None, seed=7,
                              twins=None, hold=True):
    """The loss and every parameter's gradient at full width (seeded random
    weights, the same t and x0, the batch featurized once on the CPU: the
    first residue's pre-omega torsion is degenerate geometry, which each
    device rounds its own way) on the card (bf16 kernels) against the CPU in
    f32 (the truth), held under the rule of tests/test_fused_layer_bwd.py:
    each tensor's error is at most twice that of the plain twins run in bf16
    on the CPU, plus 0.01. Errors are relative L2 per tensor; a tensor's
    norm is taken as at least 1e-3 of the largest gradient norm (IPA's key
    bias has an exactly-zero gradient that every run rounds differently).
    The flagship config at B = 2, T = 100 by default; ``cfg`` another
    (its batch size, frames and crop, its featurizer: ``no_frames`` reads
    atom37; its task: under ``design`` the simplex point is drawn here once
    from Dir(1 + onehot(seqres) (alpha(t) - 1)) and handed to every run;
    ``pad`` residues of the first element are padding; ``extra`` goes into
    the line). ``seed``: the structure's (its noise seed + 1; t, x0 and the
    simplex point seed + 2). ``twins``: {label: wrapper names}, further card
    runs with those wrappers swapped for their plain twins (``with_twins``),
    each summarised in the line under the same rule. With ``hold`` false the
    line is returned and nothing is asserted (``--grad-seeds``)."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.training import Trainer
    from mdgen_finetune_tpu_torch.training.trainer import featurize
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    cfg = cfg or train_config(2)
    Bn, Tn, Ln = cfg.train.batch_size, cfg.data.num_frames, cfg.data.crop
    atom14, seqres, mask = make_inputs(Bn, seed, "cpu", length=Ln, pad=pad)
    noise = 0.3 * torch.randn(Bn, Tn, Ln, 14, 3,
                              generator=torch.Generator().manual_seed(seed + 1))
    atom14 = atom14[:, None] + noise
    if Ln > L:  # a protein shorter than the crop: its padding is zeros, as the dataset pads
        atom14 = atom14 * mask[:, None, :, None, None]
    batch = {"atom14": atom14, "seqres": seqres, "mask": mask}
    feats = featurize(cfg, batch["atom14"], batch["seqres"], batch["mask"])
    gen = torch.Generator().manual_seed(seed + 2)
    t = torch.rand(Bn, generator=gen) * 0.9 + 0.05
    task = cfg.task
    x0 = torch.randn(Bn, Tn, Ln, cfg.latent_dim - (20 if task.design else 0), generator=gen)
    x_d = None  # the design task's simplex point (mpnn: zeros, made by the loss)
    if task.design and not (task.mpnn or task.dynamic_mpnn):
        alpha = 1 + t * (cfg.transport.alpha_max - 1)
        conc = 1 + F.one_hot(seqres, 20).float() * (alpha[:, None, None] - 1)
        x_d = torch._sample_dirichlet(conc, gen)
    f32_cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False))
    res, secs = {}, {}
    masks = {}  # with dropout: the card's keep masks, replayed on every other run

    def run(d, c):
        from mdgen_finetune_tpu_torch.models.layers import Dropout

        tr = Trainer(c, device=d)
        tr.init_state(0)
        randomize_(tr.model, torch.Generator().manual_seed(12), scale=0.05)
        drop = None
        if c.model.dropout > 0:
            drop = (Dropout(c.model.dropout, masks=masks) if masks else
                    Dropout(c.model.dropout, torch.Generator(device=d).manual_seed(seed + 3)))
        loss, _ = tr._feature_loss({k: v.to(d) for k, v in feats.items()}, t=t.to(d),
                                   x0=x0.to(d), x_d=None if x_d is None else x_d.to(d),
                                   dropout=drop)
        loss.backward()
        if drop is not None and not masks:
            masks.update({k: v.cpu() for k, v in drop.drawn.items()})
        return loss.item(), {k: p.grad.float().cpu() for k, p in tr.model.named_parameters()}

    runs = [("cuda", dev, cfg, None), ("cpu_f32", "cpu", f32_cfg, None),
            ("cpu_bf16", "cpu", cfg, None)]
    runs += [(f"cuda_{k}", dev, cfg, names) for k, names in (twins or {}).items()]
    for name, d, c, names in runs:
        t0 = time.perf_counter()
        res[name] = with_twins(lambda: run(d, c), names) if names else run(d, c)
        secs[name] = time.perf_counter() - t0
    lt, gt = res["cpu_f32"]
    floor = 1e-3 * max(v.norm().item() for v in gt.values())

    def rel(g):
        return {k: ((g[k] - v).norm() / max(v.norm().item(), floor)).item() for k, v in gt.items()}

    ref = rel(res["cpu_bf16"][1])
    rule = {k: 2 * ref[k] + 0.01 for k in ref}

    def summary(name):
        err = rel(res[name][1])
        worst = sorted(err, key=lambda k: err[k] - 2 * ref[k])[-5:]
        return err, {"loss_rel": abs(res[name][0] - lt) / abs(lt),
                     "worst_rel_l2": max(err.values()),
                     "median_rel_l2": sorted(err.values())[len(err) // 2],
                     "over": sum(1 for k in err if not err[k] <= rule[k]),
                     "worst_of_rule": max(err[k] / rule[k] for k in err),
                     "worst_vs_rule": {k: [err[k], rule[k]] for k in worst}}

    card, line = summary("cuda")
    over = {k: (card[k], ref[k]) for k in card if not card[k] <= rule[k]}
    line = {"phase": phase, "batch": Bn, "T": Tn, "L": Ln, "layers": cfg.model.num_layers,
            "seed": seed, **(extra or {}), "dropout_masks": len(masks),
            "grad_checkpointing": cfg.model.grad_checkpointing, "seconds": secs,
            "loss_cuda": res["cuda"][0], "loss_cpu_f32": lt,
            "loss_cpu_bf16": res["cpu_bf16"][0], "params": len(card),
            "rule": "rel_l2(card) <= 2 * rel_l2(cpu bf16) + 0.01 per tensor", **line,
            "twins": {k[5:]: summary(k)[1] for k in res if k.startswith("cuda_")},
            "tol": {"loss_rel": 1e-2}}
    emit(line)
    if hold and (over or not line["loss_rel"] <= 1e-2):
        raise AssertionError(f"{phase}: card vs CPU gradients over the rule: {over}, "
                             f"loss {line['loss_rel']}")
    return line


TRAIN_WRAPPERS = ("adaln_linear", "rope_attention", "ipa_attention", "linear_bwd", "modln_bwd",
                  "rope_attention_bwd")
# the T = 1000 training path's kernel wrappers, as (module, wrapper)
WRAPPERS_1000 = tuple((n, n) for n in TRAIN_WRAPPERS + ("tiled_attention",)) + (
    ("fused_attention", "fused_attention_fwd"), ("fused_attention", "fused_attention_bwd"))


def _counters(pairs=tuple((n, n) for n in TRAIN_WRAPPERS)):
    """Kernel wrappers (module, name) and their plain twins: by default the
    six of the T = 100 training path."""
    import importlib

    mods = [importlib.import_module(f"mdgen_finetune_tpu_torch.ops.{m}") for m, _ in pairs]
    return ([getattr(m, n) for m, (_, n) in zip(mods, pairs)],
            [getattr(m, n + "_plain") for m, (_, n) in zip(mods, pairs)])


@contextlib.contextmanager
def fused_bwd_route(route):
    """``MDGEN_FUSED_BWD`` set to ``route`` inside, restored after."""
    kept = os.environ.get("MDGEN_FUSED_BWD")
    os.environ["MDGEN_FUSED_BWD"] = route
    try:
        yield
    finally:
        if kept is None:
            del os.environ["MDGEN_FUSED_BWD"]
        else:
            os.environ["MDGEN_FUSED_BWD"] = kept


MERGED_PAIR = (("fused_layer_bwd_merged", "fused_layer_bwd_merged"),)


def phase_train_path(dev, route="", ref=None):
    """The flagship config trained through ``Trainer`` from its real init.
    ``route``: the layer backward's route (``MDGEN_FUSED_BWD``); with
    ``merged`` (phase ``train_merged``) the same batches and seeds as
    ``train_path`` (``ref``: its losses and gradient norms), which it must
    repeat bit for bit, and per step 5 merged launches and no split backward
    kernel. Returns the launches, (losses, gradient norms) and (trainer,
    state, batch, generator)."""
    import numpy as np

    from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset, make_batch_iterator
    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
    from mdgen_finetune_tpu_torch.ops.ipa_encoder import ipa_encoder
    from mdgen_finetune_tpu_torch.training import Trainer

    phase = "train_merged" if route else "train_path"
    cfg = train_config(B_TRAIN)
    split = make_synthetic_dataset(cfg.data.data_dir, ["AAGG", "GHKL"], num_frames=2 * T)
    it = make_batch_iterator(MDGenDataset(cfg, split), B_TRAIN, seed=0)
    batches = [{k: torch.as_tensor(np.asarray(v), device=dev) for k, v in next(it).items()
                if k != "name"} for _ in range(22)]
    it.close()
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(0)
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.reset_peak_memory_stats()
    pairs = tuple((n, n) for n in TRAIN_WRAPPERS) + (MERGED_PAIR if route else ())
    wrappers, twins = _counters(pairs)
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "bodies"):  # rope_attention's and rope_attention_bwd's launches by body
            fn.bodies = [0] * len(fn.bodies)
    for fn in twins:
        fn.cuda_calls = 0
    ipa_encoder.bwd_recomputes = 0
    metrics = []
    with fused_bwd_route(route):
        for b in batches[:2]:  # warm-up
            state, m = trainer.train_step(state, b, gen)
            metrics.append(m)
        torch.cuda.synchronize()
        before = {fn.__name__: fn.launches for fn in wrappers}
        t0 = time.perf_counter()
        for b in batches[2:]:
            state, m = trainer.train_step(state, b, gen)
            metrics.append(m)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / 20
        per_step = {fn.__name__: (fn.launches - before[fn.__name__]) / 20 for fn in wrappers}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # 30 steps on one fixed batch with fixed t and x0: the objective is fixed
        fixed = []
        for _ in range(30):
            state, m = trainer.train_step(state, batches[0],
                                          torch.Generator(device=dev).manual_seed(5))
            fixed.append(m["loss"])
        fixed = [float(v) for v in fixed]

        # checkpoint round trip
        saved = {k: v.detach().clone() for k, v in state.params.items()}
        saved_ema = {k: v.clone() for k, v in state.ema_params.items()}
        path = trainer.save_checkpoint(state)
        state, _ = trainer.train_step(state, batches[1], gen)
        state = trainer.restore_checkpoint(path, state)
    ckpt_ok = all(torch.equal(state.params[k], v) for k, v in saved.items()) and \
        all(torch.equal(state.ema_params[k], v) for k, v in saved_ema.items())
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    bodies = {f"{fn.__name__}.bodies": list(fn.bodies) for fn in wrappers if hasattr(fn, "bodies")}
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    first5, last5 = sum(fixed[:5]) / 5, sum(fixed[-5:]) / 5
    extra = {}
    if route:
        from mdgen_finetune_tpu_torch.ops.fused_layer_bwd_merged import fused_layer_bwd_merged

        extra = {"route": route, "losses_bit_identical_to_train_path": losses == ref[0],
                 "grad_norms_bit_identical_to_train_path": norms == ref[1],
                 "merged_launch": fused_layer_bwd_merged.last_launch}
    emit({"phase": phase, "B": B_TRAIN, "T": T, "L": L, "C": C, "layers": NL,
          "dtype": "bf16", "ms_per_step": secs * 1e3, "trajectories_per_s": B_TRAIN / secs,
          "peak_memory_gb": peak_gb, "losses": losses, "grad_norms": norms,
          "fixed_batch_first5": first5, "fixed_batch_last5": last5,
          "checkpoint_round_trip": ckpt_ok, "launches_per_step": per_step,
          "launches": launches, "launches_by_body": bodies, "plain_calls_on_card": twin_calls,
          "encoder_bwd_recomputes": ipa_encoder.bwd_recomputes, **extra})
    if not all(np.isfinite(losses + norms + fixed)):
        raise AssertionError(f"{phase}: non-finite loss or gradient norm in training")
    if not last5 < first5:
        raise AssertionError(f"{phase}: fixed-batch loss did not fall: {first5} -> {last5}")
    if not ckpt_ok:
        raise AssertionError(f"{phase}: checkpoint round trip changed the state")
    if any(twin_calls.values()):
        raise AssertionError(f"{phase}: plain twins ran on the card: {twin_calls}")
    if route:
        want = {"fused_layer_bwd_merged": NL, "linear_bwd": 0, "modln_bwd": 0,
                "rope_attention_bwd": 0}
        if any(per_step[k] != v for k, v in want.items()):
            raise AssertionError(f"{phase}: launches per step {per_step}, want {want}")
        if losses != ref[0] or norms != ref[1]:
            raise AssertionError(f"{phase}: losses or gradient norms differ from train_path's: "
                                 f"{losses}, {norms} vs {ref}")
    elif min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the training path never launched: {launches}")
    elif per_step["modln_bwd"] != 3 * NL:  # row e: one call per stage and layer
        raise AssertionError(f"{phase}: {per_step['modln_bwd']} modln_bwd calls a step, "
                             f"want {3 * NL}")
    return {**launches, **bodies}, (losses, norms), (trainer, state, batches[0], gen)


def phase_rope_long_bodies(dev):
    """The long-sequence bodies of ``rope_attention`` (N > 16) and
    ``rope_attention_bwd`` (16 < N <= 128), tensor-core products with the
    RoPE'd q and k in fp16, at their edge cases against the f32 plain twins
    (max abs err <= 0.01 x max(1, max |twin|)): N = 17, 64, 100, 128, 200,
    256 forward (both softmax modes) and 17, 100, 128 backward, at head dims
    16, 24, 32, 64 (2 heads, (G, N, I) = (3, N, 2)), with masked keys, a
    sequence whose only valid key is the bias token (g = 1) and keys masked
    at random (g = 2); the natural mode with q x 400 (logits ~1e3, q and k
    nonzero in the first half of each head's lanes) against the plain math
    with the kernel's fp16 rounding (``rope_attention_math(stage=float16)``);
    the backward at dO ~ 1e-6 and with RoPE'd q ~ 2e5, k ~ 1e-5 (beyond
    fp16's range), where each of dq, dk, dv is also held within 0.01 of its
    own largest value. Reported per group: the worst error as a share of
    its tolerance. Also both bodies' resources at each N (registers, local
    bytes, shared memory, blocks per SM; 16 heads of D = 24)."""
    from mdgen_finetune_tpu_torch.ops import rope_attention as RA
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RBM

    g = torch.Generator(device=dev).manual_seed(61)
    Hc = 2

    def case(N, D, qs=1.0, ks=1.0, half=False):
        Cc = Hc * D
        qkv = torch.randn(3, N, 2, 3 * Cc, generator=g, device=dev)
        qkv[..., :Cc] *= qs
        qkv[..., Cc:2 * Cc] *= ks
        bk = torch.randn(Cc, generator=g, device=dev) * ks
        if half:
            qkv.view(3, N, 2, 3, Hc, 2, D // 2)[..., :2, :, 1, :] = 0
            bk.view(Hc, 2, D // 2)[:, 1] = 0
        mask = torch.ones(3, N, 2, device=dev)
        mask[0, N // 2:, -1] = 0
        mask[1] = 0
        mask[2] = (torch.rand(N, 2, generator=g, device=dev) > 0.3).float()
        bv = torch.randn(Cc, generator=g, device=dev)
        return qkv.to(torch.bfloat16), bk.to(torch.bfloat16), bv.to(torch.bfloat16), mask

    worst = {}

    def hold(group, name, got, ref, own=False):
        scale = max(1.0, ref.float().abs().max().item())
        share = (got.float() - ref.float()).abs().max().item() / (1e-2 * scale)
        if own:
            share = max(share, (got.float() - ref.float()).abs().max().item()
                        / (1e-2 * ref.float().abs().max().item()))
        if not share <= 1.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"rope_long_bodies[{name}]: {share} of the tolerance")
        worst[group] = max(worst.get(group, 0.0), share)

    for D in (16, 24, 32, 64):
        for N in (17, 64, 100, 128, 200, 256):
            qkv, bk, bv, mask = case(N, D)
            for base2 in (True, False):
                got = RA.rope_attention(qkv, bk, bv, mask, num_heads=Hc, base2=base2)
                ref = RA.rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask,
                                              num_heads=Hc, base2=base2)
                hold(f"fwd_{'base2' if base2 else 'natural'}", f"fwd D={D} N={N} base2={base2}",
                     got, ref)
        for N in (100, 256):
            qkv, bk, bv, mask = case(N, D, qs=400.0 * D ** -0.5, half=True)
            got = RA.rope_attention(qkv, bk, bv, mask, num_heads=Hc, base2=False)
            ref = RA.rope_attention_math(qkv.float(), bk.float(), bv.float(), mask, num_heads=Hc,
                                         base2=False, stage=torch.float16)
            hold("fwd_natural_q400_vs_fp16_staged", f"fwd D={D} N={N} q x 400", got, ref)
        for N, qs, ks, gs in [(17, 1.0, 1.0, 1.0), (100, 1.0, 1.0, 1.0), (128, 1.0, 1.0, 1.0),
                              (100, 1.0, 1.0, 1e-6), (100, 2e5, 1e-5 * D ** -0.5, 1.0)]:
            qkv, bk, bv, mask = case(N, D, qs=qs, ks=ks)
            do = (torch.randn(3, N, 2, Hc * D, generator=g, device=dev) * gs).to(torch.bfloat16)
            got = RBM.rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
            ref = RBM.rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(),
                                               mask, num_heads=Hc)
            group = "bwd" if (qs, ks, gs) == (1.0, 1.0, 1.0) else (
                "bwd_dO_1e-6" if gs != 1.0 else "bwd_beyond_fp16_range")
            special = group != "bwd"
            Cc = Hc * D
            for j, part in enumerate(("dq", "dk", "dv")):
                hold(group, f"bwd D={D} N={N} {part}", got[0][..., j * Cc:(j + 1) * Cc],
                     ref[0][..., j * Cc:(j + 1) * Cc], own=special)
            hold(group, f"bwd D={D} N={N} dbk", got[1], ref[1])
            hold(group, f"bwd D={D} N={N} dbv", got[2], ref[2])
    torch.cuda.synchronize()
    res = {"fwd": {N: RA.resources(N, H, C) for N in (17, 64, 100, 128, 200, 256)},
           "bwd": {N: RBM.resources(N, H, C) for N in (17, 100, 128)}}
    out = {"worst_share_of_tol": worst, "resources_D24_16_heads": res}
    emit({"phase": "rope_long_bodies", **out})
    return out


def layer_case(dev, Bc, Tc, seed):
    """Seeded f32 inputs of one trunk layer at the flagship's width (L = 4,
    C = 384): x, mod, the 16 weights, a mask with a padded residue and a
    frame whose only valid residue key is the bias token, dout."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=g, device=dev) * sc

    shapes = dict(wqkv_l=(C, 3 * C), bqkv_l=(3 * C,), wout_l=(C, C), bout_l=(C,),
                  wqkv_t=(C, 3 * C), bqkv_t=(3 * C,), wout_t=(C, C), bout_t=(C,),
                  w1=(C, 4 * C), b1=(4 * C,), w2=(4 * C, C), b2=(C,), bkl=(C,), bvl=(C,),
                  bkt=(C,), bvt=(C,))
    w = {k: r(*sh, sc=(sh[0] ** -0.5 if k[0] == "w" else 0.4)) for k, sh in shapes.items()}
    M = Bc * Tc * L
    mask = torch.ones(Bc, Tc, L, device=dev)
    mask[0, :, -1] = 0  # a padded residue
    mask[-1, 2, :] = 0  # a frame whose only valid residue key is the bias token
    return r(M, C), r(Bc, 9 * C, sc=0.3), w, mask, r(M, C)


def merged_raw(lib, FM, args, who):
    """``lib``'s merged layer backward called on ``args``' launch slots
    straight from ctypes, without the wrapper's Python (the raw launch):
    (run, info)."""
    import ctypes

    ptrs, ints, _ = FM.launch_slots(*args)
    fn = lib.fused_layer_bwd
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
    p_arr = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr() for t in ptrs])
    i_arr = (ctypes.c_longlong * len(ints))(*ints)
    info = (ctypes.c_longlong * 3)()
    stream = torch.cuda.current_stream().cuda_stream

    def run(_slots=ptrs):  # the slots' tensors live as long as run
        code = fn(ctypes.addressof(p_arr), ctypes.addressof(i_arr), ctypes.addressof(info), stream)
        if code:
            raise RuntimeError(f"{who} fused_layer_bwd failed to launch: cudaError {code}")

    return run, info


def merged_parent_times(FM, args, split):
    """With MDGEN_PARENT_CSRC: the parent's merged layer backward's raw
    launch on the same launch slots (its entry point reads the first of this
    checkout's integer slots, the layout it had), and the split route on the
    parent's adaln_linear; else None."""
    plib = parent_lib("fused_layer_bwd")
    if plib is None:
        return None
    run, info = merged_raw(plib, FM, args, "the parent's")
    return dict(ms=time_ms(run, reps=10), back_to_back_ms=back_to_back_ms(run, n=20),
                smem_bytes=info[2], blocks_per_sm=info[1],
                split=parent_times("adaln_linear", split))


def phase_merged_bwd_kernels(dev):
    """Row 4' (the merged layer backward: one cooperative launch per layer)
    at the training path's shape (B = 32, T = 100, L = 4, C = 384, 16 heads,
    a padded residue, seeded random weights), and at T = 200 (B = 4), where
    the frame stage takes the blocked core: against the split route on the
    same bf16 inputs (bit for bit expected), and against the plain version
    in f32 under the composition rule (relative L2 at most 2 x that of the
    plain version in bf16, + 0.01, per output). Times (CUDA events, median):
    the merged launch (through its wrapper, and raw: ``merged_raw``), the
    split route's launches for one layer, the plain
    version (bf16 twins on the card). Bound: the split route's work less the
    dx round trips: the products of the recompute and of both backward
    products (96 M C^2 FLOP) and the attention cores (14 N (N + 1) D per
    sequence and head and stage) against the layer's inputs and outputs read
    and written once."""
    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.ops import fused_layer_bwd_merged as FM
    from mdgen_finetune_tpu_torch.ops.fused_layer import trunk_layer
    from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import layer_bwd_split
    from mdgen_finetune_tpu_torch.ops.residue_block import residue_block_plain
    from mdgen_finetune_tpu_torch.tools import merged_phase_clock as MPC
    from mdgen_finetune_tpu_torch.ops.time_attention import time_attention_block_plain

    wrappers, _ = _counters(tuple((n, n) for n in TRAIN_WRAPPERS + ("blocked_attention_bwd",)))
    out = {}
    for name, (Bc, Tc) in (("T100", (B_TRAIN, T)), ("T200", (4, 200))):
        x, mod, w, mask, dout = layer_case(dev, Bc, Tc, seed=41 + Tc)
        bf = torch.bfloat16
        xb, modb, wb = x.to(bf), mod.to(bf), {k: v.to(bf) for k, v in w.items()}
        x1, x2, _ = trunk_layer(xb, modb, wb, mask, B=Bc, T=Tc, L=L, num_heads=H)
        args = (xb, x1, x2, dout, modb, wb, mask, H)

        def flat(res):
            dx, dmod, dw = res
            return [("dx", dx), ("dmod", dmod)] + [(k, dw[k]) for k in sorted(dw)]

        before = {fn.__name__: fn.launches for fn in wrappers}
        split = flat(layer_bwd_split(*args))
        split_launches = {k: fn.launches - before[k] for k, fn in
                          ((fn.__name__, fn) for fn in wrappers) if fn.launches > before[k]}
        n0 = FM.fused_layer_bwd_merged.launches
        merged = flat(FM.fused_layer_bwd_merged(*args))
        torch.cuda.synchronize()
        if FM.fused_layer_bwd_merged.launches != n0 + 1:
            raise AssertionError("merged_bwd_kernels: the merged kernel did not launch once")
        launch = FM.fused_layer_bwd_merged.last_launch
        differ = [k for (k, a), (_, b) in zip(merged, split) if not torch.equal(a, b)]
        plain_bf = flat(FM.fused_layer_bwd_merged_plain(*args))

        def m(j):
            return mod[:, j * C:(j + 1) * C]

        dims = dict(B=Bc, T=Tc, L=L, num_heads=H)
        p1 = residue_block_plain(x, m(0), m(1), m(2), w["wqkv_l"], w["bqkv_l"], w["wout_l"],
                                 w["bout_l"], w["bkl"], w["bvl"], mask, **dims)
        p2 = time_attention_block_plain(p1, m(3), m(4), m(5), w["wqkv_t"], w["bqkv_t"],
                                        w["wout_t"], w["bout_t"], w["bkt"], w["bvt"], mask, **dims)
        truth = flat(FM.fused_layer_bwd_merged_plain(x, p1, p2, dout, mod, w, mask, H))

        def rel(a, b):
            return ((a.float() - b.float()).norm() / max(b.float().norm().item(), 1e-12)).item()

        rule = {k: [rel(a, t), 2 * rel(p, t) + 0.01] for (k, a), (_, p), (_, t) in
                zip(merged, plain_bf, truth)}
        over = {k: v for k, v in rule.items() if not v[0] <= v[1]}
        finite = all(bool(torch.isfinite(a).all()) for _, a in merged)
        err = max((a.float() - t.float()).abs().max().item() for (_, a), (_, t) in zip(merged, truth))
        M = Bc * Tc * L
        flops = 96.0 * M * C * C + 14.0 * C * M * (Tc + 1 + L + 1)
        io = nbytes(xb, x1, x2, dout, modb, mask, *wb.values()) + M * C * 4 + \
            Bc * 9 * C * 4 + sum(v.numel() for v in wb.values()) * 4
        bound = bound_ms(io, flops)
        out[name] = dict(
            parent=merged_parent_times(FM, args, lambda: layer_bwd_split(*args)),
            shape=f"B={Bc}, T={Tc}, L={L}, C={C}, {H} heads (M = {M} rows), one layer",
            bit_identical_to_split=not differ, differ_from_split=differ,
            rule_worst={k: rule[k] for k in sorted(rule, key=lambda k: rule[k][0] - rule[k][1])[-3:]},
            max_abs_err=err, tol="composition rule, per output", launch=launch,
            ms=time_ms(lambda: FM.fused_layer_bwd_merged(*args), reps=10),
            raw_ms=time_ms(merged_raw(_cuda.built("fused_layer_bwd"), FM, args, "this")[0],
                           reps=10),
            split_ms=time_ms(lambda: layer_bwd_split(*args), reps=10),
            split_launches=split_launches,
            plain_ms=time_ms(lambda: FM.fused_layer_bwd_merged_plain(*args), reps=3, warmup=1),
            library_ms=None, bound=bound,
            split_bound_ms=bound_ms(io + 4 * M * C * 4, flops)[0],
            phase_clock=MPC.measure(name, Bc, Tc, 5, MPC.clock_library()))
        if over or not finite:
            raise AssertionError(f"merged_bwd_kernels[{name}]: over the rule: {over}")
        if differ:
            raise AssertionError(f"merged_bwd_kernels[{name}]: not the split route's bits: {differ}")
    emit({"phase": "merged_bwd_kernels", "kernels": out})
    return out


def with_twins(fn, names=TRAIN_WRAPPERS + ("tiled_attention", "blocked_attention_bwd")):
    """``fn()`` with the kernel wrappers ``names`` (by default every one)
    swapped for their plain twins (run on the same card tensors) wherever the
    trunk, its stage ops, its backward, the encoder and the denoiser itself
    (the design FinalLayer, the modular layers) call them; the wrappers are
    put back after."""
    import importlib

    def ops(n):
        return importlib.import_module(f"mdgen_finetune_tpu_torch.ops.{n}")

    twin_of = {n: getattr(ops(n), n + "_plain") for n in names}
    users = [ops(m) for m in ("fused_layer", "fused_layer_bwd", "residue_block",
                              "time_attention", "adaln_mlp", "modular_stage", "residue_attention",
                              "sharded_trunk")]
    users += [importlib.import_module(f"mdgen_finetune_tpu_torch.models.{m}")
              for m in ("denoiser", "attention", "ipa")]
    uses = [(m, n) for m in users for n in names if hasattr(m, n)]
    kept = [getattr(m, n) for m, n in uses]
    IE = ops("ipa_encoder")
    kept_enc = IE.KERNELS
    for m, n in uses:
        setattr(m, n, twin_of[n])
    IE.KERNELS = tuple(twin_of.get(f.__name__, f) for f in kept_enc)
    try:
        return fn()
    finally:
        for (m, n), k in zip(uses, kept):
            setattr(m, n, k)
        IE.KERNELS = kept_enc


def phase_rows_1_2(dev, eng, batch):
    """Rows 1 and 2 of the kernel table as a whole at the flagship sampler's
    shape (B = 64, T = 100, L = 4, 5 x 384): one Euler step (``flat_call``:
    the embed, five layers, the head and the update) and the encoder over the
    100-point t grid (``encode_steps``), each timed with the kernels and with
    every wrapper swapped for its plain twin on the same bf16 card tensors."""
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    m = eng.model
    prep = prep_batch(eng.cfg, {k: v for k, v in batch.items() if torch.is_tensor(v)})
    kw = prep["model_kwargs"]
    mask = kw["mask"].float().contiguous()
    pack = m.make_trunk_pack()
    consts = m.make_scan_consts(kw["x_cond"], kw["x_cond_mask"], mask, aatype=kw["aatype"])
    ts = 0.01 * torch.arange(STEPS, dtype=torch.float32, device=dev)
    encs = m.encode_steps(ts, mask, consts, pack, kw["start_frames"])
    mods = m.embed_mods(m.embed_times(ts), pack)
    lat = eng.cfg.latent_dim
    xc = torch.randn(B, T, L, lat, generator=torch.Generator(device=dev).manual_seed(51),
                     device=dev)

    def step():
        return m.flat_call(xc.clone(), mask, consts, pack, 0.01, enc=encs[0], mods=mods[0:1])

    def encode():
        return m.encode_steps(ts, mask, consts, pack, kw["start_frames"])

    M = B * T * L
    flops_step = (NL * (2.0 * M * C * C * 16 + 4.0 * M * (L + 1) * C
                        + 4.0 * B * L * H * T * (T + 1) * (C // H)) + 2.0 * M * lat * C * 2)
    weights = nbytes(*[w for layer in pack["layers"] for w in layer.values()], *pack["fin"])
    b1 = bound_ms(weights + nbytes(xc, consts["cadd"], encs[0], mods[0], mask) + xc.numel() * 4,
                  flops_step)
    b2 = encoder_bound(STEPS * B)
    rows = {
        "row1_euler_step": dict(ms=time_ms(step, reps=10), plain_ms=with_twins(
            lambda: time_ms(step, reps=5)), bound_ms=b1[0], bound_by=b1[1], library_ms=None),
        "row2_encoder_grid": dict(ms=time_ms(encode, reps=10), plain_ms=with_twins(
            lambda: time_ms(encode, reps=5)), bound_ms=b2[0], bound_by=b2[1], library_ms=None),
    }
    emit({"phase": "rows_1_2", "B": B, "T": T, "L": L, "C": C, "layers": NL,
          "encoder_elements": STEPS * B, **rows})


def phase_trunk_rows(dev):
    """Rows 3 and 4 of the kernel table as a whole, at the training shape
    (B = 32, T = 100, L = 4, 5 x 384, one padded residue, seeded random
    weights): the trunk's training forward (``FusedTrunkFn.forward``: the
    five layers and the head, saving x_in, X1, X2) and its backward (the
    head's VJP, then ``fused_layer_bwd`` per layer). Each is timed with the
    kernels and with every wrapper swapped for its plain twin on the same
    bf16 card tensors, and both are held to the plain twins in f32 under the
    rule of ``grad_cuda_vs_cpu``."""
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.ops import fused_layer as FL
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    wrappers, _ = _counters()
    cfg = train_config(B_TRAIN)
    model = randomize_(LatentMDGen(cfg).to(dev), torch.Generator().manual_seed(31), scale=0.05)
    g = torch.Generator(device=dev).manual_seed(32)
    M = B_TRAIN * T * L
    mask = torch.ones(B_TRAIN, T, L, device=dev)
    mask[0, :, -1] = 0
    x = torch.randn(B_TRAIN, T, L, C, generator=g, device=dev)
    mods = 0.3 * torch.randn(B_TRAIN, NL * 9 * C, generator=g, device=dev)
    modf = 0.3 * torch.randn(B_TRAIN, 2 * C, generator=g, device=dev)
    names = ["x", "mods", "modf", "wfin", "bfin"] + [f"{k}[{i}]" for i in range(NL)
                                                     for k in FL.LAYER_KEYS]

    def leaves(dt):
        pack = model.make_trunk_pack(dt)
        ins = [x.to(dt), mods.to(dt), modf.to(dt), *pack["fin"]]
        ins += [w[k] for w in pack["layers"] for k in FL.LAYER_KEYS]
        return [t.detach().clone().requires_grad_() for t in ins]

    def forward(ins):
        return FL.fused_trunk_train(ins[0], ins[1], FL._unflatten(ins[5:]), mask, num_heads=H,
                                    final=tuple(ins[2:5]))

    ins = leaves(torch.bfloat16)
    out_c = ins[3].shape[1]
    gv = torch.randn(B_TRAIN, T, L, out_c, generator=g, device=dev)

    def run(ins, timed):
        out = forward(ins)
        ms = None
        if timed:
            ms = (time_ms(lambda: forward(ins), reps=10, warmup=2),
                  time_ms(lambda: torch.autograd.grad(out, ins, gv, retain_graph=True),
                          reps=10, warmup=2))
        return [out.detach().float()] + [t.float() for t in torch.autograd.grad(out, ins, gv)], ms

    before = {fn.__name__: fn.launches for fn in wrappers}
    out = forward(ins)
    mid = {fn.__name__: fn.launches for fn in wrappers}
    torch.autograd.grad(out, ins, gv)
    after = {fn.__name__: fn.launches for fn in wrappers}
    del out
    card, (fwd_ms, bwd_ms) = run(ins, True)
    plain, (fwd_plain_ms, bwd_plain_ms) = with_twins(lambda: run(ins, True))
    truth, _ = with_twins(lambda: run(leaves(torch.float32), False))
    floor = 1e-3 * max(b.norm().item() for b in truth[1:])

    def rel(got):
        return [((a - b).norm() / max(b.norm().item(), floor)).item() for a, b in zip(got, truth)]

    rc, rp = rel(card), rel(plain)
    names = ["velocity"] + names
    over = {n: (a, 2 * b + 0.01) for n, a, b in zip(names, rc, rp) if not a <= 2 * b + 0.01}
    worst = sorted(range(len(names)), key=lambda i: rc[i] - 2 * rp[i])[-4:]

    f_layer = 2.0 * M * C * C * 16 + 4.0 * M * (L + 1) * C + 4.0 * M * (T + 1) * C
    flops_fwd = NL * f_layer + 2.0 * M * C * out_c
    w_bytes = nbytes(*ins[3:])
    saved_bytes = NL * 3 * M * C * 2
    bound3 = bound_ms(nbytes(*ins[:3]) + w_bytes + saved_bytes + M * out_c * 4, flops_fwd)
    # the backward recomputes each stage from its saved input (nothing else
    # is kept), then takes the data and weight products: three forwards
    bound4 = bound_ms(saved_bytes + nbytes(*ins) * 2 + gv.numel() * 4, 3.0 * flops_fwd)
    rows = {
        "row3_forward": dict(ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=bound3[0],
                             bound_by=bound3[1], library_ms=None,
                             launches={k: mid[k] - before[k] for k in mid if mid[k] > before[k]}),
        "row4_backward": dict(ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bound4[0],
                              bound_by=bound4[1], library_ms=None,
                              launches={k: after[k] - mid[k] for k in after if after[k] > mid[k]}),
    }
    emit({"phase": "trunk_rows", "B": B_TRAIN, "T": T, "L": L, "C": C, "layers": NL,
          "saved_bytes": saved_bytes, **rows,
          "rule": "rel_l2(card) <= 2 * rel_l2(plain bf16) + 0.01 per tensor, truth: plain f32",
          "tensors": len(names), "worst_rel_l2": max(rc),
          "worst_vs_rule": {names[i]: [rc[i], 2 * rp[i] + 0.01] for i in worst}})
    if over:
        raise AssertionError(f"trunk rows 3-4 over the rule: {over}")
    return rows


def random_engine(dev, cfg, seed, **engine_kw):
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(seed), scale=0.05)
    return InferenceEngine(cfg, model.state_dict(), device=dev, **engine_kw), model.state_dict()


def make_inputs(n, seed, dev, length=L, pad=1):
    """A frame-0 atom14 batch of ``length`` residues built by the port's own
    reconstruction; the first element's last ``pad`` residues are padding
    (mask 0, aatype 0, zero coordinates, as the ATLAS dataset pads)."""
    from mdgen_finetune_tpu_torch.geometry import frames as G
    from mdgen_finetune_tpu_torch.geometry.rigid import Rigid

    g = torch.Generator().manual_seed(seed)
    seqres = torch.randint(0, 20, (n, length), generator=g)
    t7 = torch.randn(n, length, 7, generator=g)
    t7[..., 4:] = torch.arange(length)[None, :, None] * 3.8 + t7[..., 4:]
    ang = (torch.rand(n, length, 7, generator=g) * 2 - 1) * torch.pi
    tors = torch.stack([ang.sin(), ang.cos()], -1)
    atom14 = G.frames_torsions_to_atom14(Rigid.from_tensor_7(t7), tors, seqres)
    mask = torch.ones(n, length)
    if pad:
        mask[0, -pad:] = 0
        if length > L:  # a protein shorter than the crop: its padding is zeros
            seqres[0, -pad:] = 0
            atom14[0, -pad:] = 0
    return atom14.to(dev), seqres.to(dev), mask.to(dev)


def ptxas_report(log):
    """Registers / shared memory / spills per compiled kernel, from nvcc
    -Xptxas -v; kernels named by their template arguments (c++filt where
    the machine has it)."""
    if not log.exists():
        return []
    out, name = [], "?"
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            name = kernel_name(ln.split("'")[1])
        elif "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def kernel_name(mangled):
    """`ns::kernel<args>` of a mangled kernel symbol (the mangled name, cut,
    without c++filt)."""
    try:
        full = subprocess.run(["c++filt", mangled], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled[:48]
    head = full.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split(" ")[-1] if head.startswith("void ") else head


def bonds(atom14, mask):
    valid = mask.bool()[:, None, :].expand(atom14.shape[:3])
    n_ca = (atom14[..., 0, :] - atom14[..., 1, :]).norm(dim=-1)[valid]
    ca_c = (atom14[..., 1, :] - atom14[..., 2, :]).norm(dim=-1)[valid]
    return n_ca, ca_c


def phase_step_across_devices(dev, cfg):
    """One flat Euler step at B=2: the card (kernels, bf16) against the CPU
    (plain twins, f32), same random weights and inputs."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    eng, sd = random_engine(dev, cfg, seed=11)
    cpu = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)),
                          sd, device="cpu")
    atom14, seqres, mask = make_inputs(2, 3, "cpu")
    zs = torch.randn(2, T, L, cfg.latent_dim, generator=torch.Generator().manual_seed(4))
    vel, per_step = {}, {}
    wrappers, _ = fwd_counters()
    for name, e in (("cuda", eng), ("cpu", cpu)):
        d = e.device
        batch = e._expand_frame0(atom14.to(d), seqres.to(d), mask.to(d))
        kw = prep_batch(e.cfg, batch)["model_kwargs"]
        mk = kw["mask"].float().contiguous()
        m = e.model
        pack = m.make_trunk_pack()
        consts = m.make_scan_consts(kw["x_cond"], kw["x_cond_mask"], mk, aatype=kw["aatype"])
        ts = torch.full((1,), 0.4, device=d)
        enc = m.encode_steps(ts, mk, consts, pack, kw["start_frames"])
        mods = m.embed_mods(m.embed_times(ts), pack)
        xc = zs.to(d).clone()
        before = {fn.__name__: fn.launches for fn in wrappers}
        m.flat_call(xc, mk, consts, pack, 1.0, enc=enc[0], mods=mods)
        if name == "cuda":
            per_step = {fn.__name__: fn.launches - before[fn.__name__] for fn in wrappers}
        vel[name] = (xc - zs.to(d)).float().cpu()
    rel = ((vel["cuda"] - vel["cpu"]).norm() / vel["cpu"].norm()).item()
    tol = 5e-2
    emit({"phase": "step_cuda_vs_cpu", "batch": 2, "rel_l2": rel, "tol": tol,
          "velocity_norm_cpu": vel["cpu"].norm().item(), "launches_per_step": per_step})
    if not rel <= tol:
        raise AssertionError(f"card vs CPU step: relative L2 {rel} > {tol}")
    want = {"adaln_linear": 32, "rope_attention": 10, "ipa_attention": 0, "tiled_attention": 0}
    if per_step != want:
        raise AssertionError(f"launches per Euler step at T = {T}: {per_step}, expected {want}")


FWD_WRAPPERS = ("adaln_linear", "rope_attention", "ipa_attention", "tiled_attention")


def fwd_counters():
    """The sampler's kernel wrappers (their ``launches`` counts) and their
    plain twins (their ``cuda_calls`` counts)."""
    import importlib

    mods = [importlib.import_module(f"mdgen_finetune_tpu_torch.ops.{n}") for n in FWD_WRAPPERS]
    return ([getattr(m, n) for m, n in zip(mods, FWD_WRAPPERS)],
            [getattr(m, n + "_plain") for m, n in zip(mods, FWD_WRAPPERS)])


def flagship_config(method="euler", steps=None):
    """The flagship sampler's config (``bench.py:29-34``): 5 x 384, 16
    heads, prepend-IPA, abs_pos_emb, sim_condition, L = 4, T = 100, bf16."""
    from mdgen_finetune_tpu_torch.config import (DataConfig, MDGenConfig, ModelConfig,
                                                 TaskConfig, TransportConfig)

    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(sampling_method=method, inference_steps=steps or STEPS))


def sim_config(method, steps=None):
    """The 4AA forward-simulation preset at full width (5 x 384, 16 heads,
    prepend-IPA, T = 1000, L = 4, bf16) with the given ODE sampler."""
    from mdgen_finetune_tpu_torch.config import (DataConfig, ModelConfig, TransportConfig,
                                                 preset_4aa_sim)

    cfg = preset_4aa_sim(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        transport=TransportConfig(sampling_method=method, inference_steps=steps or STEPS),
        workdir=str(SCRATCH))
    return cfg.replace(data=dataclasses.replace(cfg.data, num_frames=T_SIM))


def phase_step_across_devices_1000(dev):
    """One velocity evaluation (``forward_inference``) of the preset at
    B = 1, T = 1000: the card (kernels, bf16) against the CPU (plain twins,
    f32), same random weights, the batch featurized once on the CPU."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    cfg = sim_config("dopri5")
    eng, sd = random_engine(dev, cfg, seed=13)
    cpu = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)),
                          sd, device="cpu")
    atom14, seqres, mask = make_inputs(1, 14, "cpu")
    feats = cpu._expand_frame0(atom14, seqres, mask)
    zs = torch.randn(1, T_SIM, L, cfg.latent_dim, generator=torch.Generator().manual_seed(15))
    wrappers, _ = fwd_counters()
    vel = {}
    for name, e in (("cuda", eng), ("cpu", cpu)):
        d = e.device
        kw = prep_batch(e.cfg, {k: v.to(d) for k, v in feats.items()})["model_kwargs"]
        before = {fn.__name__: fn.launches for fn in wrappers}
        v = e.model.forward_inference(zs.to(d), torch.full((1,), 0.4, device=d), kw["mask"],
                                      start_frames=kw["start_frames"], x_cond=kw["x_cond"],
                                      x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
        if name == "cuda":
            per_eval = {fn.__name__: fn.launches - before[fn.__name__] for fn in wrappers}
        vel[name] = v.float().cpu()
    rel = ((vel["cuda"] - vel["cpu"]).norm() / vel["cpu"].norm()).item()
    tol = 5e-2
    emit({"phase": "step_cuda_vs_cpu_1000", "batch": 1, "T": T_SIM, "rel_l2": rel, "tol": tol,
          "velocity_norm_cpu": vel["cpu"].norm().item(), "launches_per_eval": per_eval})
    if not rel <= tol or not torch.isfinite(vel["cuda"]).all():
        raise AssertionError(f"card vs CPU velocity at T = {T_SIM}: relative L2 {rel} > {tol}")
    if per_eval["tiled_attention"] != NL or per_eval["rope_attention"] != 2 * NL:
        raise AssertionError(f"launches per velocity evaluation: {per_eval}")


def encoder_bound(Bn, Hi=4, Ch=32, Pq=8, Pv=8):
    """The least time of the prepend-IPA encoder (row 2 of the TPU kernel
    table) over Bn elements of L residues: its products (the affine-LN
    projections, the IPA core, linear_out, the residue MHA and the MLP, for
    NL layers) over the bf16 peak, or its bytes (tokens in and out, frames,
    mask and every layer's weights once) over the memory rate."""
    from mdgen_finetune_tpu_torch.ops.ipa_attention import feat_width, proj_width

    tok = Bn * L
    pw, fw = proj_width(Hi, Ch, Pq, Pv), feat_width(Hi, Ch, Pv)
    core = L * L * Hi * Bn * (2 * Ch + Pq * 3 * 3 + 2 * (Ch + Pv * 3))
    per_layer = (2.0 * tok * C * pw + core + 2.0 * tok * fw * C + 2.0 * tok * C * 4 * C
                 + 4.0 * tok * (L + 1) * C + 16.0 * tok * C * C)
    weights = NL * (C * pw + fw * C + 4 * C * C + 8 * C * C + 6 * C * C) * 2
    return bound_ms(2 * tok * C * 2 + Bn * L * (12 + 1) * 4 + weights, NL * per_layer)


def phase_main_path(dev, cfg):
    from mdgen_finetune_tpu_torch.ops import adaln_linear as al
    from mdgen_finetune_tpu_torch.ops import ipa_attention as ia
    from mdgen_finetune_tpu_torch.ops import rope_attention as ra

    eng, _ = random_engine(dev, cfg, seed=21)
    atom14, seqres, mask = make_inputs(B, 5, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = eng._expand_frame0(atom14, seqres, mask)
    eng.sample(batch, gen)  # warm-up
    torch.cuda.synchronize()

    wrappers = (al.adaln_linear, ra.rope_attention, ia.ipa_attention)
    twins = (al.adaln_linear_plain, ra.rope_attention_plain, ia.ipa_attention_plain)
    for fn in wrappers:
        fn.launches = 0
    for fn in twins:
        fn.cuda_calls = 0
    al.adaln_linear.routes = [0, 0, 0]
    ra.rope_attention.bodies = [0, 0, 0]
    ia.ipa_attention.forms = [0, 0, 0, 0]
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_sample = {fn.__name__: fn.launches for fn in wrappers}
    # ipa_attention's forms: the encoder (L = 4) takes the streaming form only
    ipa_forms = list(ia.ipa_attention.forms)
    if ipa_forms != [per_sample["ipa_attention"], 0, 0, 0]:
        raise AssertionError(f"main_path: ipa_attention's forms {ipa_forms}, expected all streaming")
    # adaln_linear's routes per sample, as derived from the code: per Euler
    # step 5 resident products (qkv and out of both attention stages, fc1)
    # and fc2 pipelined in each layer, the embed and the head on tiled64;
    # the encoder's 6 products a layer (5 resident, fc2 pipelined) once
    routes = dict(zip(al.ROUTES, al.adaln_linear.routes))
    want_routes = dict(resident=5 * NL * (STEPS + 1), pipelined=NL * (STEPS + 1), tiled64=2 * STEPS)
    if routes != want_routes:
        raise AssertionError(f"main_path: adaln_linear's routes {routes}, expected {want_routes}")
    traj = eng.rollout(atom14, seqres, mask, 2, gen)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    bodies = list(ra.rope_attention.bodies)  # short base 2 (stage 1), short natural (encoder), long
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}

    enc_bound = encoder_bound(STEPS * B)
    traj = torch.from_numpy(traj)
    assert out.shape == (B, T, L, 14, 3) and traj.shape == (B, 2 * T, L, 14, 3)
    assert torch.isfinite(out).all() and torch.isfinite(traj).all(), "non-finite output"
    n_ca, ca_c = bonds(torch.cat([out.cpu(), traj], 1), mask.cpu())
    dev_nca, dev_cac = (n_ca - 1.458).abs().max().item(), (ca_c - 1.522).abs().max().item()
    emit({"phase": "main_path", "B": B, "T": T, "L": L, "C": C, "layers": NL, "steps": STEPS,
          "dtype": "bf16", "sample_s": secs, "steps_per_s": B * STEPS / secs,
          "launches_per_sample": per_sample, "launches": launches,
          "adaln_linear_routes_per_sample": routes, "rope_attention_bodies": bodies,
          "ipa_attention_forms_per_sample": ipa_forms,
          "plain_calls_on_card": twin_calls, "rollout_windows": 2,
          "n_ca_mean": n_ca.mean().item(), "ca_c_mean": ca_c.mean().item(),
          "n_ca_max_dev": dev_nca, "ca_c_max_dev": dev_cac,
          "encoder_bound_ms": enc_bound[0], "encoder_bound_by": enc_bound[1]})
    if dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if any(twin_calls.values()):
        raise AssertionError(f"plain twins ran on the card: {twin_calls}")
    return ({**launches, "rope_attention.bodies": bodies, "per_sample": per_sample},
            (eng, batch, gen))


def output_checks(name, out, mask, twin_calls):
    """Finite output, ideal backbone bonds and the plain twins idle."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    n_ca, ca_c = bonds(out.cpu(), mask.cpu())
    dev_nca, dev_cac = (n_ca - 1.458).abs().max().item(), (ca_c - 1.522).abs().max().item()
    if dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"{name}: backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")
    if any(twin_calls.values()):
        raise AssertionError(f"{name}: plain twins ran on the card: {twin_calls}")
    return dict(n_ca_mean=n_ca.mean().item(), ca_c_mean=ca_c.mean().item(),
                n_ca_max_dev=dev_nca, ca_c_max_dev=dev_cac)


def sample_checks(name, out, mask, launches, twin_calls, evals):
    """``output_checks``, and at T = 1000 the frame stage on
    ``tiled_attention`` (once per layer per velocity evaluation) with
    ``rope_attention`` serving only stage 1 and the encoder."""
    checks = output_checks(name, out, mask, twin_calls)
    if launches["tiled_attention"] != NL * evals:
        raise AssertionError(f"{name}: tiled_attention launched {launches}, not {NL} per evaluation")
    return checks


def phase_sim_1000(dev):
    """The 4AA forward-simulation preset on the card (T = 1000, L = 4,
    5 x 384, bf16, seeded random weights) through ``InferenceEngine.sample``:
    B = 8 with Euler-100 after a warm-up, then Heun-10 and the preset's own
    dopri5 at B = 1 with the same weights."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine

    eng, sd = random_engine(dev, sim_config("euler"), seed=23)
    atom14, seqres, mask = make_inputs(B_SIM, 24, dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    batch = eng._expand_frame0(atom14, seqres, mask)
    eng.sample(batch, gen)  # warm-up
    torch.cuda.synchronize()
    wrappers, twins = fwd_counters()

    def reset():
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0

    def read():
        return ({fn.__name__: fn.launches for fn in wrappers},
                {fn.__name__: fn.cuda_calls for fn in twins})

    reset()
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, twin_calls = read()
    assert out.shape == (B_SIM, T_SIM, L, 14, 3)
    checks = sample_checks("sim_1000", out, mask, launches, twin_calls, STEPS)
    if launches["rope_attention"] != NL * STEPS + NL:  # stage 1, and the encoder's one pass
        raise AssertionError(f"sim_1000: rope_attention launched {launches}")
    M = B_SIM * T_SIM * L
    lat = eng.cfg.latent_dim
    flops_step = (NL * (2.0 * M * C * C * 16 + 4.0 * M * (L + 1) * C
                        + 4.0 * B_SIM * L * H * T_SIM * (T_SIM + 1) * (C // H))
                  + 2.0 * M * lat * C * 2)
    small = {}
    for method, steps in (("heun", 10), ("dopri5", None)):
        e = InferenceEngine(sim_config(method, steps), sd, device=dev)
        b1 = e._expand_frame0(atom14[:1], seqres[:1], mask[:1])
        reset()
        t0 = time.perf_counter()
        o, _ = e.sample(b1, gen)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        lz, tc = read()
        small[method] = dict(sample_s=s, **e.last_counts, launches=lz,
                             **sample_checks(method, o, mask[:1], lz, tc, e.last_counts["evals"]))
        if lz["rope_attention"] != 2 * NL * e.last_counts["evals"]:
            raise AssertionError(f"{method}: rope_attention launched {lz}")
        del e
    emit({"phase": "sim_1000", "B": B_SIM, "T": T_SIM, "L": L, "C": C, "layers": NL,
          "steps": STEPS, "dtype": "bf16", "sample_s": secs, "frames_per_s": B_SIM * T_SIM / secs,
          "steps_per_s": B_SIM * STEPS / secs, "ms_per_step": secs / STEPS * 1e3,
          "bound_ms_per_step": flops_step / PEAK_BF16_FLOPS * 1e3, "flops_per_step": flops_step,
          "launches_per_sample": launches, "plain_calls_on_card": twin_calls, **checks,
          "b1_heun10": small["heun"], "b1_dopri5": small["dopri5"]})
    return launches, (eng, batch, gen)


def phase_sim_cli(dev):
    """The forward-simulation CLI on the card: ``cli.synth_data`` writes one
    1,100-frame peptide, a ``Trainer`` checkpoint of the preset with seeded
    random weights is saved, and ``cli.sim_inference`` rolls out 2 windows
    of 1,000 frames with the preset's dopri5; the PDB must parse back to
    2,000 models of 4 residues with ideal backbone bonds."""
    import numpy as np

    from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data
    from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models, from_pdb_string
    from mdgen_finetune_tpu_torch.training import Trainer
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    data, out, ckpt = SCRATCH / "sim_data", SCRATCH / "sim_out", SCRATCH / "sim_ckpt"
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "--num_frames", "1100",
                     "--suffix", "_i100"])
    trainer = Trainer(sim_config("dopri5"), device=dev)
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(41), scale=0.05)
    trainer.save_checkpoint(state, str(ckpt))
    del trainer, state
    t0 = time.perf_counter()
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(data),
                        "--split", str(data / "split.csv"), "--out_dir", str(out),
                        "--num_frames", str(T_SIM), "--num_rollouts", "2", "--suffix", "_i100",
                        "--device", str(dev)])
    secs = time.perf_counter() - t0
    meta = json.loads((out / "AAGG_meta.json").read_text())
    path = out / "AAGG.pdb"
    models = from_pdb_models(str(path))
    pos = np.stack([from_pdb_string(c).atom_positions
                    for c in path.read_text().split("ENDMDL") if "ATOM" in c])
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    dev_nca, dev_cac = float(np.abs(n_ca - 1.458).max()), float(np.abs(ca_c - 1.522).max())
    residues = sorted({len(a) for a, _ in models})
    emit({"phase": "sim_cli", "meta": meta, "cli_s": secs, "models": len(models),
          "residues_per_model": residues, "pdb_bytes": path.stat().st_size,
          "n_ca_max_dev": dev_nca, "ca_c_max_dev": dev_cac})
    shutil.rmtree(ckpt, ignore_errors=True)  # data and out stay for analysis_cli
    if len(models) != 2 * T_SIM or residues != [L] or meta["frames"] != 2 * T_SIM:
        raise AssertionError(f"sim_cli: {len(models)} models of {residues} residues")
    if not np.isfinite(pos).all() or dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"sim_cli: backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")


def count_calls(model, names):
    """Count the calls of ``model``'s methods ``names`` (instance attributes
    over the class's methods; ``del`` puts them back)."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(model, n)

        def run(*a, _n=n, _fn=fn, **k):
            calls[_n] += 1
            return _fn(*a, **k)
        setattr(model, n, run)
    return calls


def tps_config(method="euler", steps=None):
    """``preset_4aa_tps`` at full width (5 x 384, 16 heads, prepend-IPA
    4 x 32, abs_pos_emb, L = 4, T = 100, bf16) with the given ODE sampler
    (the preset's own is dopri5)."""
    from mdgen_finetune_tpu_torch.config import ModelConfig, TransportConfig, preset_4aa_tps

    return preset_4aa_tps(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        transport=TransportConfig(sampling_method=method, inference_steps=steps or STEPS),
        workdir=str(SCRATCH))


def make_endpoints(eng, n, seed, dev):
    """Synthetic endpoint windows of the transition-path task, featurized:
    frames 0..T-2 hold a start structure and frame T-1 an end structure of
    the same sequence (backbone frames moved by ~1 rad and ~3 A, new
    torsions), built by the port's own reconstruction; the first element's
    last residue is padding. Returns (batch, mask)."""
    from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch
    from mdgen_finetune_tpu_torch.geometry import frames as G
    from mdgen_finetune_tpu_torch.geometry.rigid import Rigid

    g = torch.Generator().manual_seed(seed)
    seqres = torch.randint(0, 20, (n, L), generator=g)
    t7 = torch.randn(2, n, L, 7, generator=g)
    t7[..., 4:] = torch.arange(L)[:, None] * 3.8 + t7[..., 4:]
    t7[1] = t7[0] + torch.randn(n, L, 7, generator=g) * torch.tensor([0.5] * 4 + [3.0] * 3)
    ang = (torch.rand(2, n, L, 7, generator=g) * 2 - 1) * torch.pi
    ends = G.frames_torsions_to_atom14(Rigid.from_tensor_7(t7),
                                       torch.stack([ang.sin(), ang.cos()], -1),
                                       seqres.expand(2, n, L))
    frames = eng.cfg.data.num_frames
    atom14 = ends[0][:, None].repeat(1, frames, 1, 1, 1)
    atom14[:, -1] = ends[1]
    mask = torch.ones(n, L)
    mask[0, -1] = 0
    return featurize_atom14_batch(atom14.to(dev), seqres.to(dev), mask.to(dev)), mask.to(dev)


# launches of one velocity evaluation at T = 100 (L = 4): the trunk's embed,
# 6 products a layer and the head; stage 1 and stage 2 of each layer;
# and of one encoder pass (6 products, the residue MHA and the IPA a layer)
TRUNK_PER_EVAL = {"adaln_linear": 6 * NL + 2, "rope_attention": 2 * NL, "ipa_attention": 0,
                  "tiled_attention": 0}
ENCODER_PER_PASS = {"adaln_linear": 6 * NL, "rope_attention": NL, "ipa_attention": NL,
                    "tiled_attention": 0}


def phase_tps_main(dev, sim_launches):
    """The transition-path preset on the card (``preset_4aa_tps``: T = 100,
    L = 4, 5 x 384, bf16, seeded random weights) over synthetic endpoints:
    ``InferenceEngine.sample`` at B = 64 with Euler-100 on the flat chain
    (no ``forward_inference`` call: every step one ``flat_call``; the
    encoder's token pair over the whole t grid as one pass of 2 x 100 x 64
    elements), then the preset's dopri5 at B = 1 through ``forward_inference``
    / ``sample_ode`` (one encoder pass of 2 elements per evaluation); the
    launches exactly as derived, the encoder's beside ``main_path``'s; the
    paired encoder against its two-pass form on the card; one velocity
    evaluation (B = 2) on the card against the CPU."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    eng, sd = random_engine(dev, tps_config("euler"), seed=141)
    batch, mask = make_endpoints(eng, B, 142, dev)
    gen = torch.Generator(device=dev).manual_seed(143)
    calls = count_calls(eng.model, ("forward_inference", "flat_call"))
    eng.sample(batch, gen)  # warm-up
    torch.cuda.synchronize()
    wrappers, twins = fwd_counters()

    def reset():
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0
        for k in calls:
            calls[k] = 0

    def read():
        return ({fn.__name__: fn.launches for fn in wrappers},
                {fn.__name__: fn.cuda_calls for fn in twins})

    reset()
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, twin_calls = read()
    flat_calls = dict(calls)
    assert out.shape == (B, T, L, 14, 3)
    checks = output_checks("tps_main", out, mask, twin_calls)
    want = {k: STEPS * TRUNK_PER_EVAL[k] + ENCODER_PER_PASS[k] for k in TRUNK_PER_EVAL}
    if launches != want or flat_calls != {"forward_inference": 0, "flat_call": STEPS}:
        raise AssertionError(f"tps_main: launches {launches}, calls {flat_calls}; expected "
                             f"{want}, {STEPS} flat calls and no forward_inference")
    encoder = {k: launches[k] - STEPS * TRUNK_PER_EVAL[k] for k in launches}
    sim_encoder = {k: sim_launches[k] - STEPS * TRUNK_PER_EVAL[k] for k in sim_launches}

    # the paired encoder as one call against its two passes, on the card
    m = eng.model
    kw = prep_batch(eng.cfg, batch)["model_kwargs"]
    with torch.no_grad():
        pack = m.make_trunk_pack()
        mk = kw["mask"][:, 0].float().contiguous()
        toks = m.make_encoder_tokens(mk, kw["aatype"], kw["start_frames"], kw["end_frames"])
        t_emb = m.embed_times(torch.full((B,), 0.4, device=dev))
        both = m.run_ipa(t_emb, mk, kw["start_frames"], kw["end_frames"], toks, pack)
        two = (m.run_ipa(t_emb, mk, kw["start_frames"], None, toks[1:], pack)
               + m.run_ipa(t_emb, mk, kw["end_frames"], None, toks[:1], pack))
    pair_err = (both.float() - two.float()).abs().max().item()
    pair_tol = 1e-2 * max(1.0, two.float().abs().max().item())
    if not pair_err <= pair_tol:
        raise AssertionError(f"tps_main: the paired encoder off its two passes by {pair_err}")

    # the preset's dopri5 at B = 1 on the generic route
    e1 = InferenceEngine(tps_config("dopri5"), sd, device=dev)
    b1 = {k: v[1:2] for k, v in batch.items()}
    reset()
    t0 = time.perf_counter()
    o1, _ = e1.sample(b1, gen)
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    lz, tc = read()
    evals = e1.last_counts["evals"]
    want1 = {k: evals * (TRUNK_PER_EVAL[k] + ENCODER_PER_PASS[k]) for k in TRUNK_PER_EVAL}
    dopri = dict(sample_s=s1, **e1.last_counts, launches=lz,
                 **output_checks("tps_dopri5", o1, mask[1:2], tc))
    if lz != want1:
        raise AssertionError(f"tps dopri5: launches {lz}, expected {want1}")
    del e1

    # one velocity evaluation (B = 2, t = 0.4): card (bf16 kernels) vs CPU (f32 twins)
    cpu = InferenceEngine(eng.cfg.replace(model=dataclasses.replace(eng.cfg.model, use_bf16=False)),
                          sd, device="cpu")
    zs = torch.randn(2, T, L, eng.cfg.latent_dim, generator=torch.Generator().manual_seed(144))
    vel = {}
    for name, e in (("cuda", eng), ("cpu", cpu)):
        d = e.device
        k2 = prep_batch(e.cfg, {k: v[:2].to(d) for k, v in batch.items()})["model_kwargs"]
        with torch.no_grad():
            vel[name] = e.model.forward_inference(
                zs.to(d), torch.full((2,), 0.4, device=d), k2["mask"],
                start_frames=k2["start_frames"], end_frames=k2["end_frames"],
                x_cond=k2["x_cond"], x_cond_mask=k2["x_cond_mask"],
                aatype=k2["aatype"]).float().cpu()
    del cpu
    rel = ((vel["cuda"] - vel["cpu"]).norm() / vel["cpu"].norm()).item()
    tol = 5e-2
    emit({"phase": "tps_main", "B": B, "T": T, "L": L, "C": C, "layers": NL, "steps": STEPS,
          "dtype": "bf16", "latent_dim": eng.cfg.latent_dim, "sample_s": secs,
          "sample_ms": secs * 1e3, "frames_per_s": B * T / secs,
          "steps_per_s": B * STEPS / secs, "launches_per_sample": launches,
          "launches_derived": want, "model_calls": flat_calls,
          "encoder_launches_per_sample": encoder, "main_path_encoder_launches": sim_encoder,
          "encoder_elements": 2 * STEPS * B, "main_path_encoder_elements": STEPS * B,
          "plain_calls_on_card": twin_calls, **checks,
          "paired_encoder_vs_two_passes": dict(max_abs_err=pair_err, tol=pair_tol),
          "b1_dopri5": dopri, "launches_per_eval_dopri5_derived": {
              k: TRUNK_PER_EVAL[k] + ENCODER_PER_PASS[k] for k in TRUNK_PER_EVAL},
          "velocity_cuda_vs_cpu": dict(batch=2, rel_l2=rel, tol=tol,
                                       velocity_norm_cpu=vel["cpu"].norm().item())})
    if not rel <= tol or not torch.isfinite(vel["cuda"]).all():
        raise AssertionError(f"tps velocity card vs CPU: relative L2 {rel} > {tol}")
    if any(encoder[k] != v for k, v in sim_encoder.items()):
        raise AssertionError(f"tps_main: the encoder's launches {encoder} differ from "
                             f"main_path's {sim_encoder}")
    return eng, batch, gen


def pdb_frames(path):
    """A multi-MODEL PDB's atom37 positions (models, L, 37, 3) and its
    backbone bonds' largest deviations from 1.458 / 1.522 A."""
    import numpy as np

    from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_string

    pos = np.stack([from_pdb_string(c).atom_positions
                    for c in Path(path).read_text().split("ENDMDL") if "ATOM" in c])
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    return pos, float(np.abs(n_ca - 1.458).max()), float(np.abs(ca_c - 1.522).max())


def phase_tps_cli(dev):
    """The transition-path CLI on the card: the full-width random weights of
    ``preset_4aa_tps`` written as a released-format ``.ckpt`` with its
    ``config.json`` (``utils.torch_compat.write_reference_checkpoint``, the
    writer of the CPU tests), a 300-frame synthetic "AGHK" trajectory
    (``cli.synth_data``), then ``tps_inference --torch_ckpt ... --num_batches
    1 --batch_size 2`` with the preset's dopri5: 2 metadata rows, 2 PDBs of
    T models with ideal bonds, and each window's end structure conditioned
    (frame T-1's ``x_cond_mask`` 1)."""
    import numpy as np

    from mdgen_finetune_tpu_torch.cli import synth_data, tps_inference
    from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.tasks import prep_batch
    from mdgen_finetune_tpu_torch.utils.torch_compat import write_reference_checkpoint
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    data, out, ckpt = SCRATCH / "tps_data", SCRATCH / "tps_out", SCRATCH / "tps_ckpt"
    cfg = tps_config("dopri5")
    synth_data.main(["--outdir", str(data), "--peptides", "AGHK", "--num_frames", "300",
                     "--suffix", "_i100"])
    ckpt.mkdir(parents=True, exist_ok=True)
    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(151), scale=0.05)
    write_reference_checkpoint(str(ckpt / "model.ckpt"), model.state_dict(), cfg)
    (ckpt / "config.json").write_text(cfg.to_json())
    del model
    t0 = time.perf_counter()
    tps_inference.main(["--torch_ckpt", str(ckpt / "model.ckpt"), "--data_dir", str(data),
                        "--split", str(data / "split.csv"), "--suffix", "_i100",
                        "--out_dir", str(out), "--num_batches", "1", "--batch_size", "2"])
    secs = time.perf_counter() - t0
    meta_path = out / "AGHK_metadata.json"
    if not meta_path.exists():
        raise AssertionError("tps_cli: no metadata written (the peptide was skipped)")
    meta = json.loads(meta_path.read_text())
    arr = np.load(data / "AGHK_i100.npy")
    aatype = str_sequence_to_aatype("AGHK")
    rows = []
    for m in meta:
        pos, dev_nca, dev_cac = pdb_frames(m["path"])
        b = tps_inference.make_endpoint_batch(arr, aatype, np.ones(L, np.float32), m["start_idx"],
                                              m["end_idx"], T)
        cond = prep_batch(cfg, b)["model_kwargs"]["x_cond_mask"][0]
        rows.append(dict(start_idx=m["start_idx"], end_idx=m["end_idx"], models=len(pos),
                         finite=bool(np.isfinite(pos).all()), n_ca_max_dev=dev_nca,
                         ca_c_max_dev=dev_cac, end_frame_conditioned=bool(cond[-1].all()),
                         middle_conditioned=int(cond[1:-1].sum())))
    emit({"phase": "tps_cli", "cli_s": secs, "paths": len(meta), "rows": rows,
          "start_state": meta[0]["start_state"] if meta else None,
          "end_state": meta[0]["end_state"] if meta else None})
    shutil.rmtree(ckpt, ignore_errors=True)  # data and out stay for analysis_cli
    if len(meta) != 2:
        raise AssertionError(f"tps_cli: {len(meta)} paths, expected 2")
    for r in rows:
        if (r["models"] != T or not r["finite"] or r["n_ca_max_dev"] > 1e-2
                or r["ca_c_max_dev"] > 1e-2 or not r["end_frame_conditioned"]
                or r["middle_conditioned"]):
            raise AssertionError(f"tps_cli: a path is off: {r}")


def phase_upsampling_cli(dev):
    """The upsampling CLI on the card: a ``Trainer.save_checkpoint`` of
    seeded random weights of ``preset_4aa_upsampling`` at full width
    (T = 1000, ``cond_interval`` 100; Euler-100, to hold the phase's time:
    dopri5 at T = 1000 is ``sim_1000``'s and ``sim_cli``'s), a 20-frame
    coarse "AAGG" trajectory (2 windows of 10 conditioning frames), then
    ``upsampling_inference --ckpt``: 2,000 models, finite, ideal bonds."""
    from mdgen_finetune_tpu_torch.cli import synth_data, upsampling_inference
    from mdgen_finetune_tpu_torch.config import ModelConfig, TransportConfig, preset_4aa_upsampling
    from mdgen_finetune_tpu_torch.training import Trainer
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    import numpy as np

    data, out, ckpt = SCRATCH / "ups_data", SCRATCH / "ups_out", SCRATCH / "ups_ckpt"
    cfg = preset_4aa_upsampling(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS),
        workdir=str(SCRATCH))
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "--num_frames", "20",
                     "--suffix", "_i100"])
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(161), scale=0.05)
    trainer.save_checkpoint(state, str(ckpt))
    del trainer, state
    t0 = time.perf_counter()
    upsampling_inference.main(["--ckpt", str(ckpt), "--data_dir", str(data),
                               "--split", str(data / "split.csv"), "--out_dir", str(out)])
    secs = time.perf_counter() - t0
    pos, dev_nca, dev_cac = pdb_frames(out / "AAGG.pdb")
    want = 20 // (cfg.data.num_frames // cfg.task.cond_interval) * cfg.data.num_frames
    emit({"phase": "upsampling_cli", "cli_s": secs, "T": cfg.data.num_frames,
          "cond_interval": cfg.task.cond_interval, "coarse_frames": 20, "models": len(pos),
          "expected_models": want, "frames_per_s": len(pos) / secs,
          "n_ca_max_dev": dev_nca, "ca_c_max_dev": dev_cac})
    shutil.rmtree(ckpt, ignore_errors=True)  # data and out stay for analysis_cli
    if len(pos) != want or want != 2000:
        raise AssertionError(f"upsampling_cli: {len(pos)} models, expected {want} (2,000)")
    if not np.isfinite(pos).all() or dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"upsampling_cli: bonds off: N-CA {dev_nca}, CA-C {dev_cac}")


def phase_analysis_cli():
    """The host-side analysis CLIs on what ``sim_cli``, ``tps_cli`` and
    ``upsampling_cli`` wrote, each against its synthetic MD reference:
    ``analyze_sim`` (the 2,000-model PDB against a 5,000-frame "AAGG"
    reference that ``cli.synth_data`` writes for this phase, long enough for
    the CLI's fixed lag-1000 TICA and reference MSM), ``analyze_tps`` (the
    2 paths against the MSM metadata ``tps_inference`` pickled, the
    300-frame "AGHK" trajectory as the replica of the budget sweep) and
    ``analyze_upsampling`` (the 2,000 frames against the 20-frame coarse
    trajectory, subsampled by 10). Host seconds of each; every JSD finite
    and in [0, 1], every autocovariance finite, the simulation's MSM fitted
    (no ``msm_error``) with finite stochastic transition matrices and
    stationary distributions. Removes the three phases' files."""
    import io
    import math
    import pickle

    import numpy as np

    from mdgen_finetune_tpu_torch.cli import (analyze_sim, analyze_tps, analyze_upsampling,
                                              synth_data)

    sim_data, sim_out, sim_ref = SCRATCH / "sim_data", SCRATCH / "sim_out", SCRATCH / "sim_ref"
    tps_data, tps_out = SCRATCH / "tps_data", SCRATCH / "tps_out"
    ups_data, ups_out = SCRATCH / "ups_data", SCRATCH / "ups_out"
    rep = SCRATCH / "tps_replica"
    rep.mkdir(parents=True, exist_ok=True)
    shutil.copy(tps_data / "AGHK_i100.npy", rep / "AGHK.npy")
    secs, buf = {}, io.StringIO()
    with contextlib.redirect_stdout(buf):
        synth_data.main(["--outdir", str(sim_ref), "--peptides", "AAGG", "--num_frames", "5000",
                         "--suffix", "_i100"])
    runs = (("analyze_sim", analyze_sim.main, ["--mddir", str(sim_ref), "--pdbdir", str(sim_out),
                                               "--suffix", "_i100", "--save"]),
            ("analyze_tps", analyze_tps.main, ["--pdbdir", str(tps_out), "--outdir",
                                               str(tps_out / "analysis"), "--repdir", str(rep),
                                               "--save"]),
            ("analyze_upsampling", analyze_upsampling.main,
             ["--mddir", str(ups_data), "--pdbdir", str(ups_out), "--suffix", "_i100",
              "--subsample", "10"]))
    for name, fn, args in runs:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(args)
        secs[name] = time.perf_counter() - t0
    with open(sim_out / "out.pkl", "rb") as f:
        sim = pickle.load(f)["AAGG"]
    with open(tps_out / "analysis" / "out.pkl", "rb") as f:
        tps = pickle.load(f)["AGHK"]
    with open(ups_out / "AAGG_autocorr.pkl", "rb") as f:
        ups = pickle.load(f)
    jsds = {**{f"sim/{k}": v for k, v in sim["JSD"].items()},
            **{f"tps/{k}": v for k, v in tps.items() if k.endswith("JSD")}}
    acs = [np.asarray(v) for part in ups.values() for v in part.values()]
    msm_keys = ("msm_transition_matrix", "msm_pi", "pcca_pi", "traj_transition_matrix",
                "traj_pi", "traj_metastable_probs", "ref_metastable_probs")
    msm = {k: np.asarray(sim[k]) for k in msm_keys if k in sim}
    emit({"phase": "analysis_cli", "host_s": secs, "sim_jsd": sim["JSD"],
          "sim_msm_error": sim.get("msm_error"),
          "sim_msm": {k: v.round(4).tolist() for k, v in msm.items() if v.ndim == 1},
          "tps": {k: float(v) for k, v in tps.items() if np.ndim(v) == 0},
          "upsampling_features": len(ups["md_autocorr"]),
          "printed": buf.getvalue().splitlines()})
    for d in (sim_data, sim_out, sim_ref, tps_data, tps_out, ups_data, ups_out, rep):
        shutil.rmtree(d, ignore_errors=True)
    if "msm_error" in sim or len(msm) != len(msm_keys):
        raise AssertionError(f"analysis_cli: the simulation's MSM: {sim.get('msm_error')}")
    if not all(np.isfinite(v).all() for v in msm.values()):
        raise AssertionError("analysis_cli: a non-finite MSM statistic")
    for k in ("msm_transition_matrix", "traj_transition_matrix"):
        if not np.allclose(msm[k].sum(1), 1.0, atol=1e-6):
            raise AssertionError(f"analysis_cli: {k} rows do not sum to 1")
    if not jsds or not all(math.isfinite(v) and 0 <= v <= 1 for v in jsds.values()):
        raise AssertionError(f"analysis_cli: JSDs {jsds}")
    if not acs or not all(np.isfinite(a).all() for a in acs):
        raise AssertionError("analysis_cli: a non-finite autocovariance")


def design_config(task=None, frame_interval=10):
    """``preset_4aa_design`` at full width (5 x 384, 16 heads of D = 24,
    prepend-IPA 4 x 32, abs_pos_emb, no_aa_emb, L = 4, T = 100, bf16;
    inpainting + design + no_torsion, the preset's Euler at 100 steps,
    ``alpha_max`` 8); ``task`` replaces the preset's task flags (mpnn /
    dynamic_mpnn + design)."""
    from mdgen_finetune_tpu_torch.config import (ModelConfig, TaskConfig, TransportConfig,
                                                 preset_4aa_design)

    cfg = preset_4aa_design(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, no_aa_emb=True, use_bf16=True),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS),
        workdir=str(SCRATCH))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, frame_interval=frame_interval))
    return cfg if task is None else cfg.replace(task=TaskConfig(**task))


def make_trajectories(n, seed, dev):
    """Synthetic T-frame trajectories of one sequence each, featurized: the
    backbone frames on a random walk (about 0.05 in the quaternion and
    0.3 A a frame), new torsions every frame, built by the port's own
    reconstruction; the first element's last residue is padding. Returns
    (batch, mask)."""
    from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch
    from mdgen_finetune_tpu_torch.geometry import frames as G
    from mdgen_finetune_tpu_torch.geometry.rigid import Rigid

    g = torch.Generator().manual_seed(seed)
    seqres = torch.randint(0, 20, (n, L), generator=g)
    t7 = torch.randn(n, 1, L, 7, generator=g)
    t7[..., 4:] = torch.arange(L)[:, None] * 3.8 + t7[..., 4:]
    walk = torch.randn(n, T, L, 7, generator=g) * torch.tensor([0.05] * 4 + [0.3] * 3)
    ang = (torch.rand(n, T, L, 7, generator=g) * 2 - 1) * torch.pi
    atom14 = G.frames_torsions_to_atom14(Rigid.from_tensor_7(t7 + walk.cumsum(1)),
                                         torch.stack([ang.sin(), ang.cos()], -1),
                                         seqres[:, None].expand(n, T, L))
    mask = torch.ones(n, L)
    mask[0, -1] = 0
    return featurize_atom14_batch(atom14.to(dev), seqres.to(dev), mask.to(dev)), mask.to(dev)


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


# launches of one evaluation of the design chain (T = 100, L = 4): the
# trunk's embed, 6 products a layer and the FinalLayer as its own product,
# stages 1 and 2 of each layer (TRUNK_PER_EVAL), and one encoder pass over
# the token pair (ENCODER_PER_PASS over 2 B elements); mpnn and
# dynamic_mpnn have no FinalLayer
def design_launches_per_eval(head=True):
    per = {k: TRUNK_PER_EVAL[k] + ENCODER_PER_PASS[k] for k in TRUNK_PER_EVAL}
    if not head:
        per["adaln_linear"] -= 1
    return per


def phase_design_main(dev):
    """The design preset on the card (``preset_4aa_design``: inpainting +
    design, T = 100, L = 4, 5 x 384, bf16, seeded random weights) over
    synthetic trajectories: ``InferenceEngine.sample`` at B = 64 with
    Euler-100 on the generic chain (``forward_inference`` each step: the
    trunk without the folded head, the FinalLayer and the design head, the
    encoder's token pair with ``x_d_to_emb`` over 2 B elements a step); the
    launches exactly as derived; bonds, the designed sequence in 0..19, the
    simplex channels of the final carry summing to 1; the warm-up sample's
    c-factor inputs (x_d, alpha of each evaluation) recomputed on the CPU,
    no NaN on the card where the CPU has none; the timed sample's middle
    evaluation (B = 64) with the kernels vs with their plain twins on the
    same card tensors; one evaluation (B = 2) card vs CPU: the continuous
    part, the flow and the logits."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.inference.sampling import sample_prior_latent
    from mdgen_finetune_tpu_torch.ops import ipa_attention as ia
    from mdgen_finetune_tpu_torch.ops import rope_attention as ra
    from mdgen_finetune_tpu_torch.tasks import prep_batch
    from mdgen_finetune_tpu_torch.transport.dirichlet import DirichletConditionalFlow

    cfg = design_config()
    eng, sd = random_engine(dev, cfg, seed=171)
    batch, mask = make_trajectories(B, 172, dev)
    gen = torch.Generator(device=dev).manual_seed(173)
    calls = count_calls(eng.model, ("forward_inference", "flat_call"))
    flow = eng.model.condflow
    seen, carries = [], []

    def recording(bs, alpha):
        out = DirichletConditionalFlow.c_factor(flow, bs, alpha)
        seen.append((bs.clone(), torch.as_tensor(alpha).clone(), torch.isnan(out)))
        return out

    decode = eng._decode
    flow.c_factor = recording
    eng._decode = lambda s, r, q: (carries.append(s), decode(s, r, q))[1]
    eng.sample(batch, gen)  # warm-up, its c-factor inputs recorded
    torch.cuda.synchronize()
    del flow.c_factor
    cpu_flow = DirichletConditionalFlow(K=20, alpha_spacing=0.001, alpha_max=cfg.transport.alpha_max)
    nan_card = nan_cpu = nan_card_only = 0
    cf_err, n_seen = 0.0, len(seen)
    for bs, alpha, nan in seen:
        ref = cpu_flow.c_factor(bs.cpu(), alpha.cpu())
        nan_cpu += int(torch.isnan(ref).sum())
        nan_card += int(nan.sum())
        nan_card_only += int((nan.cpu() & ~torch.isnan(ref)).sum())
        got = DirichletConditionalFlow.c_factor(flow, bs, alpha).cpu()
        fin = torch.isfinite(ref) & torch.isfinite(got)
        scale = max(1.0, ref[fin].abs().max().item())
        cf_err = max(cf_err, (got[fin] - ref[fin]).abs().max().item() / scale)
    del seen
    wrappers, twins = fwd_counters()

    def reset():
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0
        for k in calls:
            calls[k] = 0
        ia.ipa_attention.forms = [0, 0, 0, 0]
        ra.rope_attention.bodies = [0, 0, 0]

    # the timed sample's evaluation STEPS // 2, kept for the twin check below
    counted, kept, n_eval = eng.model.forward_inference, {}, [0]

    def keeping(x, t, mask, **kw):
        n_eval[0] += 1
        if n_eval[0] == STEPS // 2:
            kept.update(args=(x.clone(), t.clone(), mask), kw=kw)
        return counted(x, t, mask, **kw)

    eng.model.forward_inference = keeping
    reset()
    carries.clear()
    t0 = time.perf_counter()
    out, aa = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eng.model.forward_inference = counted
    launches = {fn.__name__: fn.launches for fn in wrappers}
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
    model_calls, evals, forms = dict(calls), eng.last_counts["evals"], list(ia.ipa_attention.forms)
    # rope_attention by body: short base 2 (stage 1, b′), short natural (the
    # encoder's MHA, b′), long (stage 2, b); NL of each an evaluation
    bodies = list(ra.rope_attention.bodies)
    checks = output_checks("design_main", out, mask, twin_calls)
    per_eval = design_launches_per_eval()
    want = {k: evals * v for k, v in per_eval.items()}
    carry = carries[-1]
    simplex_dev = (carry[..., -20:].sum(-1) - 1).abs().max().item()

    # that evaluation (B = 64) with the kernels and with every wrapper
    # swapped for its plain twin on the same card tensors: the unfolded
    # FinalLayer (row a, tiled64 at M = B T L) and the encoder over 2 B
    # elements at the sampled shapes
    m = eng.model

    def one_eval():
        return (m.forward_inference(*kept["args"], **kept["kw"]),
                m.denoise(*kept["args"], **kept["kw"]))

    kern = one_eval()
    twin = with_twins(one_eval)
    vs_twins = dict(continuous=rel_l2(kern[1][..., :-20].float(), twin[1][..., :-20].float()),
                    logits_plus_head=rel_l2(kern[1][..., -20:].float(), twin[1][..., -20:].float()),
                    flow=rel_l2(kern[0][..., -20:].float(), twin[0][..., -20:].float()))
    twins_finite = all(bool(torch.isfinite(v).all()) for v in (*kern, *twin))
    del kern, twin

    # one evaluation (B = 2, t = 0.4): card (bf16 kernels) vs CPU (f32 twins)
    cpu = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)), sd,
                          device="cpu")
    zs = sample_prior_latent(torch.Generator().manual_seed(174), 2, T, L, cfg.latent_dim,
                             design=True)
    got = {}
    for name, e in (("cuda", eng), ("cpu", cpu)):
        d = e.device
        k2 = prep_batch(e.cfg, {k: v[:2].to(d) for k, v in batch.items()})["model_kwargs"]
        kw = dict(start_frames=k2["start_frames"], end_frames=k2["end_frames"],
                  x_cond=k2["x_cond"], x_cond_mask=k2["x_cond_mask"], aatype=k2["aatype"])
        t2 = torch.full((2,), 0.4, device=d)
        got[name] = (e.model.forward_inference(zs.to(d), t2, k2["mask"], **kw).float().cpu(),
                     e.model.denoise(zs.to(d), t2, k2["mask"], **kw).float().cpu())
    del cpu
    parts = dict(continuous=rel_l2(got["cuda"][0][..., :-20], got["cpu"][0][..., :-20]),
                 flow=rel_l2(got["cuda"][0][..., -20:], got["cpu"][0][..., -20:]),
                 logits_plus_head=rel_l2(got["cuda"][1][..., -20:], got["cpu"][1][..., -20:]))
    tol = 5e-2
    emit({"phase": "design_main", "B": B, "T": T, "L": L, "C": C, "layers": NL, "steps": STEPS,
          "dtype": "bf16", "latent_dim": cfg.latent_dim, "task": "inpainting + design + no_torsion",
          "sample_s": secs, "sample_ms": secs * 1e3, "frames_per_s": B * T / secs,
          "ms_per_eval": secs / evals * 1e3, **eng.last_counts, "model_calls": model_calls,
          "launches_per_sample": launches, "launches_per_eval_derived": per_eval,
          "ipa_attention_forms_per_sample": forms, "rope_attention_bodies_per_sample": bodies,
          "encoder_elements_per_eval": 2 * B,
          "plain_calls_on_card": twin_calls, **checks,
          "aa_out": dict(shape=list(aa.shape), min=int(aa.min()), max=int(aa.max()),
                         distinct=int(aa.unique().numel())),
          "simplex_sum_max_dev": simplex_dev, "carry_finite": bool(torch.isfinite(carry).all()),
          "c_factor_warmup": dict(evals=n_seen, nan_card=nan_card, nan_cpu=nan_cpu,
                                  nan_card_only=nan_card_only, max_err_of_scale=cf_err),
          "kernels_vs_twins": dict(batch=B, eval=STEPS // 2, t=float(kept["args"][1][0]),
                                   rel_l2=vs_twins, tol=tol, finite=twins_finite),
          "cuda_vs_cpu": dict(batch=2, t=0.4, rel_l2=parts, tol=tol)})
    if launches != want or model_calls != {"forward_inference": STEPS, "flat_call": 0}:
        raise AssertionError(f"design_main: launches {launches}, calls {model_calls}; expected "
                             f"{want} and {STEPS} forward_inference calls")
    if forms != [launches["ipa_attention"], 0, 0, 0] or bodies != [NL * evals] * 3:
        raise AssertionError(f"design_main: ipa_attention's forms {forms}, rope_attention's "
                             f"bodies {bodies}; expected all streaming, {NL * evals} of each body")
    if aa.shape != (B, T, L) or aa.min() < 0 or aa.max() >= 20:
        raise AssertionError(f"design_main: aa_out {aa.shape}, in {int(aa.min())}..{int(aa.max())}")
    if not simplex_dev <= 1e-3 or not torch.isfinite(carry).all():
        raise AssertionError(f"design_main: the simplex channels sum to 1 +- {simplex_dev}")
    if nan_card_only:
        raise AssertionError(f"design_main: {nan_card_only} NaN c-factors on the card only")
    if not cf_err <= 1e-4:
        raise AssertionError(f"design_main: c_factor card vs CPU {cf_err} of the scale")
    if not max(vs_twins.values()) <= tol or not twins_finite:
        raise AssertionError(f"design_main: kernels vs plain twins at B = {B}: {vs_twins} > {tol}")
    if not max(parts.values()) <= tol or not all(torch.isfinite(g).all() for g in got["cuda"]):
        raise AssertionError(f"design_main: card vs CPU {parts} > {tol}")
    return launches, (eng, batch, gen)


def phase_mpnn(dev):
    """``mpnn`` and ``dynamic_mpnn`` (+ design) at the design preset's width
    on the card: ``InferenceEngine.sample`` at B = 64 is one
    ``forward_inference`` at t = 1 with the trunk at T = 1 (frame 0) or
    T = 2 (frames 0 and T-1), no FinalLayer, the design head's logits; the
    launches as derived; the sequence in 0..19 and the conditioning's own
    structures; the logits card vs CPU at B = 2; the trunk at that T (B =
    64) against its plain twins on the same card tensors, and both timed."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.ops.fused_layer import fused_trunk
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    rows = {}
    for i, task in enumerate(("mpnn", "dynamic_mpnn")):
        cfg = design_config({task: True, "design": True})
        Tn = 1 if task == "mpnn" else 2
        eng, sd = random_engine(dev, cfg, seed=181 + i)
        batch, mask = make_trajectories(B, 183 + i, dev)
        gen = torch.Generator(device=dev).manual_seed(185)
        calls = count_calls(eng.model, ("forward_inference",))
        eng.sample(batch, gen)  # warm-up
        torch.cuda.synchronize()
        wrappers, twins = fwd_counters()
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0
        calls["forward_inference"] = 0
        t0 = time.perf_counter()
        out, aa = eng.sample(batch, gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
        model_calls = dict(calls)
        checks = output_checks(task, out, mask, twin_calls)
        want = design_launches_per_eval(head=False)
        prep = prep_batch(eng.cfg, batch)
        frames_err = (out[..., 1, :] - batch["trans"]).abs().max().item()  # CA = the frames'

        # the logits card vs CPU (B = 2)
        cpu = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)),
                              sd, device="cpu")
        b2 = {k: v[:2] for k, v in batch.items()}
        _, aa_cuda = eng.sample(b2, gen)
        logits = {}
        for name, e in (("cuda", eng), ("cpu", cpu)):
            d = e.device
            p2 = prep_batch(e.cfg, {k: v.to(d) for k, v in b2.items()})
            k2 = p2["model_kwargs"]
            x1 = p2["latents"]
            xt = torch.cat([x1, x1.new_zeros(*x1.shape[:-1], 20)], -1)
            logits[name] = e.model.forward_inference(
                xt, torch.ones(2, device=d), k2["mask"], start_frames=k2["start_frames"],
                end_frames=k2["end_frames"], x_cond=k2["x_cond"], x_cond_mask=k2["x_cond_mask"],
                aatype=k2["aatype"]).float().cpu()
        del cpu
        rel = rel_l2(logits["cuda"], logits["cpu"])

        # the trunk at T = Tn against its plain twins on the card
        m = eng.model
        pack = m.make_trunk_pack()
        mods = m.embed_mods(m.embed_times(torch.full((B,), 0.5, device=dev)), pack)
        g = torch.Generator(device=dev).manual_seed(186 + i)
        h0 = torch.randn(B, Tn, L, C, generator=g, device=dev).to(torch.bfloat16)
        mk = prep["model_kwargs"]["mask"][:, :Tn].float().contiguous()

        def trunk():
            return fused_trunk(h0.clone(), mods, pack["layers"], mk, num_heads=H)

        with torch.no_grad():
            hk = trunk().float()
            hp = with_twins(trunk).float()
        trunk_rel = rel_l2(hk, hp)
        row = dict(B=B, T_trunk=Tn, sample_s=secs, sample_ms=secs * 1e3,
                   sequences_per_s=B / secs, model_calls=model_calls, **eng.last_counts,
                   launches_per_sample=launches, launches_derived=want,
                   plain_calls_on_card=twin_calls, **checks,
                   aa_out=dict(shape=list(aa.shape), min=int(aa.min()), max=int(aa.max())),
                   ca_vs_frames_max_err=frames_err,
                   logits_cuda_vs_cpu=dict(batch=2, rel_l2=rel, tol=5e-2),
                   trunk_vs_plain=dict(rel_l2=trunk_rel, tol=5e-2,
                                       finite=bool(torch.isfinite(hk).all()),
                                       ms=time_ms(trunk, reps=10),
                                       plain_ms=with_twins(lambda: time_ms(trunk, reps=5))))
        rows[task] = row
        del eng
        if launches != want or model_calls != {"forward_inference": 1}:
            raise AssertionError(f"{task}: launches {launches}, calls {model_calls}; expected "
                                 f"{want} and one forward_inference")
        if aa.shape != (B, 1, L) or aa.min() < 0 or aa.max() >= 20 or aa_cuda.shape != (2, 1, L):
            raise AssertionError(f"{task}: aa_out {aa.shape} in {int(aa.min())}..{int(aa.max())}")
        if not frames_err <= 1e-3:
            raise AssertionError(f"{task}: the structures are not the conditioning's: {frames_err}")
        if not rel <= 5e-2 or not trunk_rel <= 5e-2 or not torch.isfinite(hk).all():
            raise AssertionError(f"{task}: logits card vs CPU {rel}, trunk vs plain {trunk_rel}")
    emit({"phase": "mpnn", "L": L, "C": C, "layers": NL, "dtype": "bf16", **rows})


def phase_design_cli(dev):
    """The design CLIs on the card: the full-width random weights of
    ``preset_4aa_design`` written as a released-format ``.ckpt`` with its
    ``config.json`` (``frame_interval`` 1: the 300-frame synthetic "AGHK"
    trajectory then holds 100-frame windows between the two states), then
    ``design_inference --torch_ckpt ... --num_batches 1 --batch_size 2``
    (Euler-100, windows from the largest-flux pair of states): 2 metadata
    rows, 2 PDBs of T models with ideal bonds, ``aa_out`` (T, L) in 0..19;
    then ``analyze_design`` on the output: its ``MEAN`` line."""
    import io

    import numpy as np

    from mdgen_finetune_tpu_torch.cli import analyze_design, design_inference, synth_data
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.utils.torch_compat import write_reference_checkpoint
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    data, out, ckpt = SCRATCH / "design_data", SCRATCH / "design_out", SCRATCH / "design_ckpt"
    cfg = design_config(frame_interval=None)
    synth_data.main(["--outdir", str(data), "--peptides", "AGHK", "--num_frames", "300",
                     "--suffix", "_i100"])
    ckpt.mkdir(parents=True, exist_ok=True)
    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(191), scale=0.05)
    write_reference_checkpoint(str(ckpt / "model.ckpt"), model.state_dict(), cfg)
    (ckpt / "config.json").write_text(cfg.to_json())
    del model
    t0 = time.perf_counter()
    design_inference.main(["--torch_ckpt", str(ckpt / "model.ckpt"), "--data_dir", str(data),
                           "--split", str(data / "split.csv"), "--suffix", "_i100",
                           "--out_dir", str(out), "--num_frames", str(T), "--num_batches", "1",
                           "--batch_size", "2"])
    secs = time.perf_counter() - t0
    meta_path = out / "AGHK_metadata.json"
    if not meta_path.exists():
        raise AssertionError("design_cli: no metadata written (the peptide was skipped)")
    meta = json.loads(meta_path.read_text())
    rows = []
    for m in meta:
        pos, dev_nca, dev_cac = pdb_frames(m["path"])
        aa = np.asarray(m["aa_out"])
        rows.append(dict(start_idx=m["start_idx"], end_idx=m["end_idx"], models=len(pos),
                         finite=bool(np.isfinite(pos).all()), n_ca_max_dev=dev_nca,
                         ca_c_max_dev=dev_cac, aa_out_shape=list(aa.shape),
                         aa_out_range=[int(aa.min()), int(aa.max())]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analyze_design.main(["--pdbdir", str(out)])
    mean = [ln for ln in buf.getvalue().splitlines() if ln.startswith("MEAN ")]
    emit({"phase": "design_cli", "cli_s": secs, "samples": len(meta), "rows": rows,
          "start_state": meta[0]["start_state"] if meta else None,
          "end_state": meta[0]["end_state"] if meta else None,
          "analyze_design": mean[0] if mean else None})
    for d in (data, out, ckpt):
        shutil.rmtree(d, ignore_errors=True)
    if len(meta) != 2 or not mean or "design_recovery" not in mean[0]:
        raise AssertionError(f"design_cli: {len(meta)} samples, analyze_design said {mean}")
    for r in rows:
        if (r["models"] != T or not r["finite"] or r["n_ca_max_dev"] > 1e-2
                or r["ca_c_max_dev"] > 1e-2 or r["aa_out_shape"] != [T, L]
                or not 0 <= r["aa_out_range"][0] <= r["aa_out_range"][1] < 20):
            raise AssertionError(f"design_cli: a sample is off: {r}")


# ---------------------------------------------------------------------------
# the reverse-SDE sampler, the probability-flow log-likelihood and the
# no_offsets / no_frames ablations
# ---------------------------------------------------------------------------
def sde_engine(dev, sd, cfg=None, method="Euler", last_step="Mean", steps=STEPS):
    from mdgen_finetune_tpu_torch.inference import InferenceEngine

    return InferenceEngine(cfg or flagship_config(), sd, device=dev, sampler="sde",
                           sde_opts=dict(num_steps=steps, method=method, last_step=last_step))


def forward_kwargs(eng, batch):
    """The model's keyword inputs of a featurized batch (``prep_batch``)."""
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    kw = prep_batch(eng.cfg, {k: v.to(eng.device) for k, v in batch.items()
                              if torch.is_tensor(v)})["model_kwargs"]
    return kw["mask"].float(), dict(start_frames=kw["start_frames"], x_cond=kw["x_cond"],
                                    x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])


def composition(card, plain, truth):
    """The relative L2 of the card's result and of the plain bf16 twins'
    against the f32 truth, and whether the card is within the repo's rule
    rel(card) <= 2 rel(plain bf16) + 0.01."""
    rc, rp = rel_l2(card.float().cpu(), truth.float().cpu()), rel_l2(plain.float().cpu(),
                                                                     truth.float().cpu())
    return dict(card=rc, plain_bf16=rp, limit=2 * rp + 0.01), rc <= 2 * rp + 0.01


def phase_sde_main(dev):
    """The flagship config (5 x 384, 16 heads, prepend-IPA 4 x 32,
    abs_pos_emb, sim_condition, L = 4, T = 100, bf16, seeded random weights)
    sampled with the reverse SDE through ``InferenceEngine(sampler="sde")``:
    B = 64, Euler-Maruyama, 100 steps and the ``Mean`` last step, 101
    evaluations of ``forward_inference`` (never ``flat_call``), each the
    trunk's 32 ``adaln_linear`` and 10 ``rope_attention`` launches and one
    encoder pass (30 + 5 + 5 ``ipa_attention``), asserted; bonds; two
    generators give two samples. The timed sample's middle evaluation is
    rerun with the kernels, with every wrapper swapped for its plain twin
    (bf16) and with the plain twins in f32 on the same card (the truth),
    held to rel(card) <= 2 rel(plain bf16) + 0.01. Then Heun with the
    ``Tweedie`` last step at B = 8, 20 steps (41 evaluations), with the same
    checks; and card vs CPU at B = 2, Euler-Maruyama 4 steps, with the same
    prior and noise handed to both (the carry before decoding and the atoms)."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.ops import rope_attention as ra

    cfg = flagship_config()
    eng, sd = random_engine(dev, cfg, seed=181, sampler="sde",
                            sde_opts=dict(num_steps=STEPS, method="Euler", last_step="Mean"))
    atom14, seqres, mask = make_inputs(B, 182, dev)
    batch = eng._expand_frame0(atom14, seqres, mask)
    gen = torch.Generator(device=dev).manual_seed(183)
    calls = count_calls(eng.model, ("forward_inference", "flat_call"))
    eng.sample(batch, gen)  # warm-up
    torch.cuda.synchronize()
    wrappers, twins = fwd_counters()
    per_eval = design_launches_per_eval()  # the trunk with its head, one encoder pass over B

    def reset():
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0
        for k in calls:
            calls[k] = 0
        ra.rope_attention.bodies = [0, 0, 0]

    counted, kept, n_eval = eng.model.forward_inference, {}, [0]

    def keeping(x, t, mask_, **kw):
        n_eval[0] += 1
        if n_eval[0] == STEPS // 2:
            kept.update(x=x.clone(), t=t.clone())
        return counted(x, t, mask_, **kw)

    eng.model.forward_inference = keeping
    reset()
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eng.model.forward_inference = counted
    launches = {fn.__name__: fn.launches for fn in wrappers}
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
    model_calls, counts = dict(calls), dict(eng.last_counts)
    bodies = list(ra.rope_attention.bodies)
    evals = counts["evals"]
    checks = output_checks("sde_main", out, mask, twin_calls)
    other, _ = eng.sample(batch, torch.Generator(device=dev).manual_seed(184))
    gens_differ = not torch.allclose(out, other)
    del other

    # the middle evaluation: kernels, plain twins in bf16, plain twins in f32
    m_mask, kw = forward_kwargs(eng, batch)
    f32 = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)), sd,
                          device=dev)

    def one_eval(e):
        return lambda: e.model.forward_inference(kept["x"], kept["t"], m_mask, **kw)

    card = one_eval(eng)()
    plain = with_twins(one_eval(eng))
    truth = with_twins(one_eval(f32))
    vs_twins, vs_ok = composition(card, plain, truth)
    del f32, card, plain, truth

    # Heun with the Tweedie last step, B = 8, 20 steps
    heun = sde_engine(dev, sd, method="Heun", last_step="Tweedie", steps=20)
    hb = {k: v[:8] for k, v in batch.items()}
    hgen = torch.Generator(device=dev).manual_seed(185)
    heun.sample(hb, hgen)  # warm-up
    reset()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hout, _ = heun.sample(hb, hgen)
    torch.cuda.synchronize()
    heun_secs = time.perf_counter() - t1
    heun_launches = {fn.__name__: fn.launches for fn in wrappers}
    heun_counts = dict(heun.last_counts)
    heun_checks = output_checks("sde_main heun", hout, mask[:8],
                                {fn.__name__: fn.cuda_calls for fn in twins})
    hother, _ = heun.sample(hb, torch.Generator(device=dev).manual_seed(186))
    heun_differ = not torch.allclose(hout, hother)
    del heun, hother

    # card vs CPU, B = 2, 4 steps, the same prior and noise
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False))
    cpu = InferenceEngine(cfg32, sd, device="cpu", sampler="sde",
                          sde_opts=dict(num_steps=4, method="Euler", last_step="Mean"))
    card4 = sde_engine(dev, sd, steps=4)
    feats = cpu._expand_frame0(atom14[:2].cpu(), seqres[:2].cpu(), mask[:2].cpu())
    g = torch.Generator().manual_seed(187)
    zs0 = torch.randn(2, T, L, cfg.latent_dim, generator=g)
    noise = torch.randn(4, 2, T, L, cfg.latent_dim, generator=g)
    got = {}
    for name, e in (("cuda", card4), ("cpu", cpu)):
        carry = []
        decode = e._decode
        e._decode = lambda s, r, q, _d=decode, _c=carry: (_c.append(s), _d(s, r, q))[1]
        atoms, _ = e.sample_with_zs0({k: v.to(e.device) for k, v in feats.items()},
                                     zs0.to(e.device), noise=noise.to(e.device))
        got[name] = (carry[0].float().cpu(), atoms.float().cpu())
    del cpu, card4
    carry_rel = rel_l2(got["cuda"][0], got["cpu"][0])
    atoms_dev = (got["cuda"][1] - got["cpu"][1]).abs().max().item()
    tol = 5e-2
    want = {k: evals * v for k, v in per_eval.items()}
    want_heun = {k: heun_counts["evals"] * v for k, v in per_eval.items()}
    emit({"phase": "sde_main", "B": B, "T": T, "L": L, "C": C, "layers": NL, "dtype": "bf16",
          "method": "Euler-Maruyama", "steps": STEPS, "last_step": "Mean",
          "diffusion": "SBDM, norm 1", "sample_s": secs, "frames_per_s": B * T / secs,
          "ms_per_eval": secs / evals * 1e3, **counts, "model_calls": model_calls,
          "launches_per_sample": launches, "launches_per_eval_derived": per_eval,
          "rope_attention_bodies_per_sample": bodies, "plain_calls_on_card": twin_calls,
          **checks, "two_generators_differ": gens_differ,
          "kernels_vs_twins": dict(batch=B, eval=STEPS // 2, t=float(kept["t"][0]),
                                   rel_l2=vs_twins, within_rule=vs_ok,
                                   rule="rel(card) <= 2 rel(plain bf16) + 0.01, truth: "
                                        "plain f32 on the card"),
          "heun_tweedie": dict(batch=8, steps=20, sample_s=heun_secs, **heun_counts,
                               launches_per_sample=heun_launches, **heun_checks,
                               two_generators_differ=heun_differ),
          "cuda_vs_cpu": dict(batch=2, steps=4, carry_rel_l2=carry_rel,
                              atom14_max_abs_dev=atoms_dev, tol=tol)})
    if launches != want or model_calls != {"forward_inference": evals, "flat_call": 0} \
            or evals != STEPS + 1:
        raise AssertionError(f"sde_main: launches {launches}, calls {model_calls}, evals {evals};"
                             f" expected {want} over {STEPS + 1} forward_inference calls")
    if heun_launches != want_heun or heun_counts["evals"] != 2 * 20 + 1:
        raise AssertionError(f"sde_main: Heun launches {heun_launches}, expected {want_heun}")
    if not (gens_differ and heun_differ):
        raise AssertionError("sde_main: two generators gave the same sample")
    if not vs_ok:
        raise AssertionError(f"sde_main: kernels vs plain twins over the rule: {vs_twins}")
    if not carry_rel <= tol or not torch.isfinite(got["cuda"][1]).all():
        raise AssertionError(f"sde_main: card vs CPU carry {carry_rel} > {tol}")
    return launches, (eng, batch, gen)


# launches of one likelihood step (T = 100, L = 4), as derived from the
# code: the forward (``FusedTrunkFn.forward``: 6 products and stages 1 and 2
# a layer, the head; the embed is a plain product) and one encoder pass
# (``ENCODER_PER_PASS``); the backward (``layer_bwd_split`` a layer: the MLP
# stage's 2 products, 4 linear_bwd and a modln_bwd; each attention stage's
# 2 products, its forward core again, 4 linear_bwd, its backward core and a
# modln_bwd; the head's VJP is plain autograd)
LIKELIHOOD_PER_STEP = {"adaln_linear": 6 * NL + 1 + 6 * NL + 6 * NL,
                       "rope_attention": 2 * NL + NL + 2 * NL, "ipa_attention": NL,
                       "linear_bwd": 12 * NL, "modln_bwd": 3 * NL, "rope_attention_bwd": 2 * NL}


def phase_likelihood_main(dev):
    """``InferenceEngine.log_likelihood`` of the flagship config (seeded
    random weights, bf16) on synthetic 100-frame trajectories at B = 16,
    100 steps: each step one ``LatentMDGen.forward`` (the trunk through
    ``FusedTrunkFn``) and its VJP in x (``torch.autograd.grad``) with one
    Rademacher probe. ms per step, launches per step against
    ``LIKELIHOOD_PER_STEP``, the peak memory; ll finite of shape (B,);
    ``prior_logp`` against its closed form in f64; x0 and delta_logp with
    the kernels against the plain twins in bf16 and in f32 on the card (4
    steps, the same probes, the repo's rule); card vs CPU at B = 2, 2 steps,
    the same probes, against the CPU in f32 under the same rule (the CPU's
    bf16 twins give the yardstick)."""
    import math

    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.inference import sampling as S

    cfg = flagship_config()
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False))
    eng, sd = random_engine(dev, cfg, seed=191)
    Bl = 16
    batch, _ = make_trajectories(Bl, 192, dev)
    gen = torch.Generator(device=dev).manual_seed(193)
    recorded = []
    integrate = S.ode_likelihood

    def recording(*a, **k):
        out = integrate(*a, **k)
        recorded.append(out)
        return out

    S.ode_likelihood = recording
    try:
        eng.log_likelihood(batch, gen, num_steps=2)  # warm-up
        torch.cuda.synchronize()
        wrappers, twins = _counters()
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ll = eng.log_likelihood(batch, gen, num_steps=STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step = {fn.__name__: fn.launches / STEPS for fn in wrappers}
        twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
        x0, delta = recorded[-1]
        lat = x0.shape[-1]
        n = x0[0].numel()
        closed = (-n / 2 * math.log(2 * math.pi)
                  - (x0.double().cpu() ** 2).reshape(Bl, -1).sum(-1) / 2)
        prior_err = (eng.transport.prior_logp(x0).double().cpu() - closed).abs().max().item()

        # 4 steps, the same probes: kernels, plain twins in bf16, plain twins in f32
        probes = torch.randint(0, 2, (4, Bl, T, L, lat), generator=torch.Generator(
            device=dev).manual_seed(194), device=dev).float() * 2 - 1
        f32 = InferenceEngine(cfg32, sd, device=dev)

        def run(e):
            def go():
                e.log_likelihood(batch, num_steps=4, probes=probes)
                return recorded[-1]
            return go

        card = run(eng)()
        plain = with_twins(run(eng))
        truth = with_twins(run(f32))
        del f32
        twins_x0, ok_x0 = composition(card[0], plain[0], truth[0])
        twins_dl, ok_dl = composition(card[1], plain[1], truth[1])

        # card vs CPU, B = 2, 2 steps, the same probes
        small = {k: v[:2].cpu() for k, v in batch.items()}
        p2 = probes[:2, :2].cpu()
        res = {}
        for name, e in (("cuda", eng), ("cpu_f32", InferenceEngine(cfg32, sd, device="cpu")),
                        ("cpu_bf16", InferenceEngine(cfg, sd, device="cpu"))):
            e.log_likelihood({k: v.to(e.device) for k, v in small.items()}, num_steps=2,
                             probes=p2.to(e.device))
            res[name] = recorded[-1]
        cpu_x0, ok_cpu_x0 = composition(res["cuda"][0], res["cpu_bf16"][0], res["cpu_f32"][0])
        cpu_dl, ok_cpu_dl = composition(res["cuda"][1], res["cpu_bf16"][1], res["cpu_f32"][1])
    finally:
        S.ode_likelihood = integrate
    emit({"phase": "likelihood_main", "B": Bl, "T": T, "L": L, "C": C, "layers": NL,
          "dtype": "bf16", "steps": STEPS, "sample_s": secs, "ms_per_step": secs / STEPS * 1e3,
          "peak_memory_gb": peak_gb, "launches_per_step": per_step,
          "launches_per_step_derived": LIKELIHOOD_PER_STEP, "plain_calls_on_card": twin_calls,
          "ll_mean": ll.mean().item(), "ll_min": ll.min().item(), "ll_max": ll.max().item(),
          "delta_logp_mean": delta.mean().item(), "prior_logp_max_abs_err_vs_f64": prior_err,
          "kernels_vs_twins": dict(batch=Bl, steps=4, x0=twins_x0, delta_logp=twins_dl),
          "cuda_vs_cpu": dict(batch=2, steps=2, x0=cpu_x0, delta_logp=cpu_dl),
          "rule": "rel(card) <= 2 rel(plain bf16) + 0.01, truth: plain f32"})
    if per_step != {k: float(v) for k, v in LIKELIHOOD_PER_STEP.items()}:
        raise AssertionError(f"likelihood_main: launches per step {per_step}, expected "
                             f"{LIKELIHOOD_PER_STEP}")
    if any(twin_calls.values()):
        raise AssertionError(f"likelihood_main: plain twins ran on the card: {twin_calls}")
    if ll.shape != (Bl,) or not torch.isfinite(ll).all():
        raise AssertionError(f"likelihood_main: ll {ll}")
    if not prior_err <= 1e-6 * closed.abs().max().item():
        raise AssertionError(f"likelihood_main: prior_logp off its closed form by {prior_err}")
    if not (ok_x0 and ok_dl and ok_cpu_x0 and ok_cpu_dl):
        raise AssertionError(f"likelihood_main: over the rule: twins {twins_x0} {twins_dl}, "
                             f"CPU {cpu_x0} {cpu_dl}")
    return per_step, (eng, batch, gen)


def phase_sde_cli(dev):
    """``sim_inference --sde --sde_steps 50`` on the card: ``cli.synth_data``
    writes a 200-frame "AAGG" trajectory, a ``Trainer`` checkpoint of the
    flagship config with seeded random weights is saved, one 100-frame
    window is sampled; the PDB must parse back to 100 models of 4 residues
    with ideal backbone bonds."""
    from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data
    from mdgen_finetune_tpu_torch.training import Trainer
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    data, out, ckpt = SCRATCH / "sde_data", SCRATCH / "sde_out", SCRATCH / "sde_ckpt"
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "--num_frames", str(2 * T),
                     "--suffix", "_i100"])
    trainer = Trainer(flagship_config(), device=dev)
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(195), scale=0.05)
    trainer.save_checkpoint(state, str(ckpt))
    del trainer, state
    t0 = time.perf_counter()
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(data),
                        "--split", str(data / "split.csv"), "--out_dir", str(out),
                        "--num_frames", str(T), "--num_rollouts", "1", "--suffix", "_i100",
                        "--sde", "--sde_steps", "50"])
    secs = time.perf_counter() - t0
    meta = json.loads((out / "AAGG_meta.json").read_text())
    pos, dev_nca, dev_cac = pdb_frames(out / "AAGG.pdb")
    emit({"phase": "sde_cli", "meta": meta, "cli_s": secs, "models": int(pos.shape[0]),
          "residues": int(pos.shape[1]), "n_ca_max_dev": dev_nca, "ca_c_max_dev": dev_cac})
    for d in (data, out, ckpt):
        shutil.rmtree(d, ignore_errors=True)
    if pos.shape[:2] != (T, L) or meta["frames"] != T:
        raise AssertionError(f"sde_cli: {pos.shape[:2]} models x residues")
    if dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"sde_cli: backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")


def no_frames_config(batch_size):
    """The flagship width trained under ``no_frames`` (latent 111: the raw
    atom37 coordinates) without the encoder, which has no rigids to read."""
    cfg = train_config(batch_size)
    return cfg.replace(model=dataclasses.replace(cfg.model, prepend_ipa=False),
                       task=dataclasses.replace(cfg.task, no_frames=True))


def phase_ablations(dev):
    """The reference's ablations at the flagship width on the card:
    ``no_offsets`` (the offsets are the frames themselves) sampled at
    B = 64 with Euler-100 on the flat chain (100 ``flat_call``s and the
    main path's launches), bonds checked; ``no_frames`` (latent 111, no
    encoder) trained through ``Trainer`` at B = 32, T = 100: 2 warm-up and
    5 timed steps, then 10 steps on one fixed batch with fixed t and x0
    (the loss finite and falling); the head's ``adaln_linear`` (N = 111,
    the ``euler`` epilogue into the (M, 111) f32 carry) against its plain
    twin on the card and its route; every gradient card vs CPU
    (``grad_cuda_vs_cpu_no_frames``, B = 2)."""
    import numpy as np

    from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset, make_batch_iterator
    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
    from mdgen_finetune_tpu_torch.ops import adaln_linear as al
    from mdgen_finetune_tpu_torch.training import Trainer

    # no_offsets: the flat chain
    cfg = flagship_config()
    cfg = cfg.replace(task=dataclasses.replace(cfg.task, no_offsets=True))
    eng, _ = random_engine(dev, cfg, seed=201)
    atom14, seqres, mask = make_inputs(B, 202, dev)
    batch = eng._expand_frame0(atom14, seqres, mask)
    gen = torch.Generator(device=dev).manual_seed(203)
    calls = count_calls(eng.model, ("forward_inference", "flat_call"))
    eng.sample(batch, gen)  # warm-up
    wrappers, twins = fwd_counters()
    for fn in wrappers:
        fn.launches = 0
    for fn in twins:
        fn.cuda_calls = 0
    for k in calls:
        calls[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    checks = output_checks("ablations no_offsets", out, mask,
                           {fn.__name__: fn.cuda_calls for fn in twins})
    no_offsets = dict(B=B, steps=STEPS, sample_s=secs, frames_per_s=B * T / secs,
                      model_calls=dict(calls), launches_per_sample=launches, **checks)
    del eng

    # no_frames: Trainer at B = 32
    cfg = no_frames_config(B_TRAIN)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=str(SCRATCH / "nf_data")))
    split = make_synthetic_dataset(cfg.data.data_dir, ["AAGG", "GHKL"], num_frames=2 * T)
    it = make_batch_iterator(MDGenDataset(cfg, split), B_TRAIN, seed=0)
    batches = [{k: torch.as_tensor(np.asarray(v), device=dev) for k, v in next(it).items()
                if k != "name"} for _ in range(7)]
    it.close()
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(0)
    tgen = torch.Generator(device=dev).manual_seed(204)
    for b in batches[:2]:
        trainer.train_step(state, b, tgen)
    torch.cuda.synchronize()
    al.adaln_linear.routes = [0, 0, 0]
    t0 = time.perf_counter()
    for b in batches[2:]:
        state, m = trainer.train_step(state, b, tgen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    routes = {r: n / 5 for r, n in zip(al.ROUTES, al.adaln_linear.routes)}
    fixed = []
    for _ in range(10):
        state, m = trainer.train_step(state, batches[0], torch.Generator(device=dev).manual_seed(5))
        fixed.append(float(m["loss"]))
    # the head at N = 111 as FusedTrunkFn runs it (tiled64, the euler
    # epilogue into a zero (M, 111) f32 carry, dt 1) vs its plain twin in f32
    g = torch.Generator(device=dev).manual_seed(205)
    M = B_TRAIN * T * L
    h = torch.randn(M, C, generator=g, device=dev).to(torch.bfloat16)
    w = (0.05 * torch.randn(C, 111, generator=g, device=dev)).to(torch.bfloat16)
    bias = (0.05 * torch.randn(111, generator=g, device=dev)).to(torch.bfloat16)
    mod = (0.3 * torch.randn(B_TRAIN, 2 * C, generator=g, device=dev)).to(torch.bfloat16)
    carry = torch.zeros(M, 111, device=dev)
    plan = al.plan(h, w, bias, ln="plain", shift=mod[:, :C], epilogue="euler", res=carry,
                   out=carry).name
    got = al.adaln_linear(h, w, bias, ln="plain", shift=mod[:, :C], scale=mod[:, C:],
                          epilogue="euler", res=carry, dt=1.0, out=carry)
    modf = mod.float()
    ref = al.adaln_linear_plain(h.float(), w.float(), bias.float(), ln="plain",
                                shift=modf[:, :C], scale=modf[:, C:], out_dtype=torch.float32)
    head_err = (got - ref).abs().max().item()
    head_tol = 1e-2 * max(1.0, ref.abs().max().item())  # the kernels' rule
    del trainer, state
    emit({"phase": "ablations", "no_offsets": no_offsets,
          "no_frames": dict(B=B_TRAIN, T=T, L=L, latent=cfg.latent_dim, ms_per_step=ms,
                            trajectories_per_s=B_TRAIN / ms * 1e3,
                            adaln_linear_routes_per_step=routes, fixed_batch_losses=fixed,
                            head=dict(shape=[M, C, 111], plan=plan, max_abs_err=head_err,
                                      tol=head_tol))})
    if calls != {"forward_inference": 0, "flat_call": STEPS}:
        raise AssertionError(f"ablations: no_offsets left the flat chain: {calls}")
    if not all(np.isfinite(fixed)) or not fixed[-1] < fixed[0]:
        raise AssertionError(f"ablations: no_frames fixed-batch loss {fixed}")
    if plan != "tiled64" or not head_err <= head_tol:
        raise AssertionError(f"ablations: the N = 111 head ({plan}) off its twin by {head_err}")
    phase_grad_across_devices(dev, no_frames_config(2), "grad_cuda_vs_cpu_no_frames",
                              extra={"task": "no_frames, latent 111, no encoder"})


# ---------------------------------------------------------------------------
# training the design, inpainting, mpnn / dynamic_mpnn and TPS tasks
# ---------------------------------------------------------------------------

TASK_PEPTIDES = ["AAGG", "GHKL", "MKTW", "DERS"]


def task_train_config(cfg, batch_size):
    """``cfg`` trained as ``train_config``: Adam lr 1e-4, clip 1.0, EMA
    0.999, on the synthetic ``task_data`` (1,000-frame trajectories, suffix
    _i100: the design preset's ``frame_interval`` 10 keeps 100 frames)."""
    from mdgen_finetune_tpu_torch.config import TrainConfig

    return cfg.replace(
        data=dataclasses.replace(cfg.data, data_dir=str(SCRATCH / "task_data"), suffix="_i100"),
        train=TrainConfig(batch_size=batch_size, lr=1e-4, grad_clip=1.0, ema=True,
                          ema_decay=0.999),
        workdir=str(SCRATCH), run_name="train_task")


def phase_train_tasks(dev):
    """The tasks the port samples, trained through ``Trainer`` at full width
    (5 x 384, 16 heads, prepend-IPA 4 x 32, bf16) and B = 32 from the
    port's init on synthetic 1,000-frame trajectories of four peptides
    (``train_cell``: 2 warm-up and 10 timed steps, 20 steps on one fixed
    batch with a fixed t, x0 and simplex point, the loss finite and
    falling, a checkpoint round trip, the training path's six kernels each
    launched, 15 ``modln_bwd`` calls a step, no plain twin on the card):
    ``train_design`` (``preset_4aa_design``: the trunk without its head
    under ``FusedTrunkFn``, the FinalLayer and the design head, the
    Dirichlet draw on the card) and its trace ``train_design_trace``;
    ``train_mpnn`` / ``train_dynamic_mpnn`` (the trunk at T = 1 / 2, the
    logits' cross-entropy); ``train_tps`` (``preset_4aa_tps``, the doubled
    offsets and the encoder's token pair). Returns the per-step launches of
    ``train_design`` and ``train_mpnn``."""
    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset

    split = make_synthetic_dataset(str(SCRATCH / "task_data"), TASK_PEPTIDES, num_frames=1000,
                                   suffix="_i100")
    pairs = tuple((n, n) for n in TRAIN_WRAPPERS)
    cells = (("train_design", design_config(), "inpainting + design + no_torsion"),
             ("train_mpnn", design_config({"mpnn": True, "design": True}), "mpnn + design"),
             ("train_dynamic_mpnn", design_config({"dynamic_mpnn": True, "design": True}),
              "dynamic_mpnn + design"),
             ("train_tps", tps_config(), "tps_condition (preset_4aa_tps)"))
    per_steps = {}
    for phase, cfg, task in cells:
        cfg = task_train_config(cfg, B_TRAIN)
        Tn = {"train_mpnn": 1, "train_dynamic_mpnn": 2}.get(phase, T)
        products, attention = step_flops(B_TRAIN, Tn, L)
        _, per_step, (trainer, state, tbatch, tgen) = train_cell(
            dev, phase, cfg, split, B_TRAIN, pairs, 3 * products + 3.5 * attention,
            {"task": task, "T_trunk": Tn, "latent": cfg.latent_dim})
        if min(per_step.values()) <= 0 or per_step["modln_bwd"] != 3 * NL:
            raise AssertionError(f"{phase}: launches per step {per_step}")
        per_steps[phase] = per_step
        if phase == "train_design":
            phase_trace("train_design_trace", lambda: trainer.train_step(state, tbatch, tgen))
        del trainer, state
    return per_steps


def phase_frame_rows_short_t(dev):
    """Rows b′ and f′ (``rope_attention`` / ``rope_attention_bwd``, the
    short bodies) at the frame stage of ``mpnn`` / ``dynamic_mpnn``
    training: (G, N, I) = (32, T, 4) with T = 1 and 2, base 2, one frame's
    residue padded and an element whose only valid key is the bias token;
    each against its f32 plain twin (1e-2 x max(1, max |twin|)), timed
    beside it."""
    from mdgen_finetune_tpu_torch.ops import rope_attention as RA
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    g = torch.Generator(device=dev).manual_seed(211)
    D = C // H
    out = {}
    for Tn in (1, 2):
        qkv = torch.randn(B_TRAIN, Tn, L, 3 * C, generator=g, device=dev) * 0.5
        qkv[..., :C] *= D ** -0.5 * 1.4427
        qkv = qkv.bfloat16()
        do = (torch.randn(B_TRAIN, Tn, L, C, generator=g, device=dev) * 0.1).bfloat16()
        bk, bv = ((torch.randn(C, generator=g, device=dev) * 0.4).bfloat16() for _ in range(2))
        mask = torch.ones(B_TRAIN, Tn, L, device=dev)
        mask[0, :, -1] = 0
        mask[1] = 0  # only the bias key is valid
        kw = dict(num_heads=H)
        fwd = RA.rope_attention(qkv, bk, bv, mask, base2=True, **kw)
        fwd_ref = RA.rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask, base2=True,
                                          **kw)
        fwd_err = check(f"frame_rows_short_t[b' T = {Tn}]", fwd, fwd_ref, 1e-2)
        bwd = RB.rope_attention_bwd(qkv, do, bk, bv, mask, **kw)
        bwd_ref = RB.rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(),
                                              mask, **kw)
        bwd_errs = [check(f"frame_rows_short_t[f' T = {Tn} {i}]", a, b, 1e-2)
                    for i, (a, b) in enumerate(zip(bwd, bwd_ref))]
        out[f"T{Tn}"] = dict(
            shape=f"(G, N, I) = ({B_TRAIN}, {Tn}, {L}), {H} heads of D = {D}, base 2",
            b_prime=dict(max_abs_err=fwd_err[0], tol=fwd_err[1],
                         ms=time_ms(lambda: RA.rope_attention(qkv, bk, bv, mask, base2=True,
                                                              **kw)),
                         plain_ms=time_ms(lambda: RA.rope_attention_plain(
                             qkv, bk, bv, mask, base2=True, **kw), reps=5)),
            f_prime=dict(max_abs_err=max(e for e, _ in bwd_errs),
                         tol=max(t for _, t in bwd_errs),
                         ms=time_ms(lambda: RB.rope_attention_bwd(qkv, do, bk, bv, mask, **kw)),
                         plain_ms=time_ms(lambda: RB.rope_attention_bwd_plain(
                             qkv, do, bk, bv, mask, **kw), reps=5)))
    emit({"phase": "frame_rows_short_t", **out})


def phase_train_design_cli(dev):
    """The training CLI on the design task at full width: ``train
    --inpainting --design --no_torsion --no_aa_emb`` with the design
    preset's frames (``--num_frames 100 --frame_interval 10``), B = 8,
    3 steps, one validation batch and ``--inference_batches 1``: the
    designability probe samples 2 validation elements with the EMA weights
    (Euler-100) and logs ``designability_*``; every value finite, each
    recovery in [0, 1]."""
    import numpy as np

    from mdgen_finetune_tpu_torch.cli import train

    data = SCRATCH / "task_data"
    split = str(data / "split.csv")
    argv = ["--inpainting", "--design", "--no_torsion", "--prepend_ipa", "--abs_pos_emb",
            "--no_aa_emb", "--crop", "4", "--num_frames", "100", "--frame_interval", "10",
            "--suffix", "_i100", "--train_split", split, "--val_split", split,
            "--data_dir", str(data), "--batch_size", "8", "--epochs", "1",
            "--steps_per_epoch", "3", "--val_batches", "1", "--inference_batches", "1",
            "--sampling_method", "euler", "--inference_steps", str(STEPS), "--ema",
            "--print_freq", "1", "--workdir", str(SCRATCH), "--run_name", "design_train"]
    t0 = time.perf_counter()
    state = train.main(argv)
    secs = time.perf_counter() - t0
    run = SCRATCH / "design_train"
    log = [json.loads(x) for x in (run / "log.jsonl").read_text().splitlines()]
    shutil.rmtree(run, ignore_errors=True)
    probe = [m for m in log if any(k.startswith("designability_") for k in m)]
    emit({"phase": "train_design_cli", "steps": state.step, "train_cli_s": secs, "log": log})
    vals = [v for m in log for v in m.values()]
    if state.step != 3 or len(probe) != 1 or not np.isfinite(vals).all():
        raise AssertionError(f"train_design_cli: {state.step} steps, log {log}")
    if not all(0.0 <= v <= 1.0 for k, v in probe[0].items() if k.startswith("designability_")):
        raise AssertionError(f"train_design_cli: a recovery out of [0, 1]: {probe[0]}")
    if not any("val_loss_discrete" in m for m in log):
        raise AssertionError(f"train_design_cli: no design metrics in validation: {log}")


def train_1000_config(batch_size):
    """The 4AA forward-simulation preset's training at full width (5 x 384,
    16 heads, prepend-IPA, T = 1000, L = 4, bf16) with the reference
    command's ``--grad_checkpointing`` (scripts/train_4aa_forward_sim.sh),
    Adam lr 1e-4, clip 1.0, EMA 0.999."""
    from mdgen_finetune_tpu_torch.config import TrainConfig

    cfg = sim_config("dopri5")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, grad_checkpointing=True),
        data=dataclasses.replace(cfg.data, data_dir=str(SCRATCH / "data_1000")),
        train=TrainConfig(batch_size=batch_size, lr=1e-4, grad_clip=1.0, ema=True,
                          ema_decay=0.999),
        run_name="train_1000")


def held_composite(name, op, plain, args, kw, names):
    """A composition of kernels held as the trunk rows are: each output's
    relative L2 error against the plain twins in f32 at most twice that of
    the plain twins in bf16, plus 0.01. Returns {output: [error, limit]}."""
    bf = torch.bfloat16
    got = op(*args, **kw)
    truth = plain(*[a.float() if torch.is_tensor(a) and a.dtype == bf else a for a in args], **kw)
    twin = plain(*args, **kw)
    out = {}
    for n, a, b, t in zip(names, got, twin, truth):
        norm = t.float().norm().item()
        out[n] = [(a.float() - t.float()).norm().item() / norm,
                  2 * (b.float() - t.float()).norm().item() / norm + 0.01]
    over = {n: v for n, v in out.items() if not v[0] <= v[1]}
    if over:
        raise AssertionError(f"{name}: relative L2 over the rule: {over}")
    return out


def phase_long_bwd_kernels(dev):
    """The T = 1000 training path's backward pieces against their plain
    twins at the path's shapes: the fused_attention kernels (rows h and i:
    B * L * H = 512 rows of 1,000 queries over 1,001 keys, D = 24, base 2,
    masked frames; and the natural-exp softmax at N = 2048, D = 64 with a
    fully masked key tile), ``adaln_mlp_bwd`` (row 5b) at 32,000 rows and
    ``time_attention_block_bwd`` as a whole at B = 8, T = 1000. Library:
    SDPA with the same mask, forward, and forward + backward through
    autograd."""
    import math

    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import adaln_mlp as AM
    from mdgen_finetune_tpu_torch.ops import fused_attention as FA
    from mdgen_finetune_tpu_torch.ops import time_attention as TA

    g = torch.Generator(device=dev).manual_seed(9)
    bf, f32 = torch.bfloat16, torch.float32

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(dtype)

    kern = {}
    for name, (S, Hc, N, D, base2) in (("4aa_T1000", (B_SIM * L, H, T_SIM, C // H, True)),
                                       ("n2048_d64_natural", (4, 6, 2048, 64, False))):
        M = N + 1
        q = r(S, Hc, N, D, sc=0.5 * D ** -0.5 * (math.log2(math.e) if base2 else 1.0))
        k, v, do = r(S, Hc, M, D), r(S, Hc, M, D), r(S, Hc, N, D)
        kv = torch.ones(S, M, device=dev)
        kv[0, N // 2:N] = 0   # masked frames
        kv[-1, 64:128] = 0    # a key tile of masked keys only
        o, stat = FA.fused_attention_fwd(q, k, v, kv, base2=base2)
        ro, rstat = FA.fused_attention_fwd_plain(q.float(), k.float(), v.float(), kv, base2=base2)
        e_o = check(f"fused_attention_fwd[{name}]", o, ro, 1e-2)
        e_s = check(f"fused_attention_fwd[{name}].stat", stat, rstat, 1e-3)
        del ro, rstat
        grads = FA.fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)
        refs = FA.fused_attention_bwd_plain(q.float(), k.float(), v.float(), kv, o.float(), stat,
                                            do.float(), base2=base2)
        es = [check(f"fused_attention_bwd[{name}].d{n}", a, b, 1e-2)
              for n, a, b in zip("qkv", grads, refs)]
        del refs
        # SDPA's natural softmax at scale ln 2 is the base-2 softmax of q.k
        am = ((kv - 1.0) * 1e9).to(bf)[:, None, None, :]
        scale = math.log(2) if base2 else 1.0
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def lib_fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
            return torch.autograd.grad(out, leaves, do)

        again = FA.fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"fused_attention_bwd[{name}]: two calls differ")
        del again
        R = S * Hc
        run = lambda: FA.fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)  # noqa: E731
        fwd_ms = time_ms(lambda: FA.fused_attention_fwd(q, k, v, kv, base2=base2))
        bwd_ms = time_ms(run)
        shape = (f"{R} rows ({S} x {Hc} heads), {N} queries, {M} keys, D={D}, "
                 f"{'base 2' if base2 else 'natural exp'}")
        fwd = dict(shape=shape, max_abs_err=max(e_o[0], e_s[0]), tol={"o": e_o[1], "stat": e_s[1]},
                   ms=fwd_ms,
                   back_to_back_ms=back_to_back_ms(lambda: FA.fused_attention_fwd(q, k, v, kv,
                                                                                  base2=base2)),
                   resources=FA.fwd_resources(R, N, M, D, base2), ex2_floor_ms=ex2_floor_ms(R * N * M),
                   parent=parent_times("fused_attention",
                                       lambda: FA.fused_attention_fwd(q, k, v, kv, base2=base2)),
                   plain_ms=time_ms(lambda: FA.fused_attention_fwd_plain(q, k, v, kv, base2=base2),
                                    reps=5),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=am, scale=scale)),
                   bound=bound_ms(nbytes(q, k, v, kv, o, stat), 4.0 * R * N * M * D))
        # the least a backward that recomputes P does: q.k, dout.v, p^T.dout,
        # ds^T.q and ds.k
        bwd = dict(shape=shape, max_abs_err=max(e for e, _ in es), tol=es[0][1], ms=bwd_ms,
                   fwd_plus_bwd_ms=fwd_ms + bwd_ms,
                   plain_ms=time_ms(lambda: FA.fused_attention_bwd_plain(
                       q, k, v, kv, o, stat, do, base2=base2), reps=5),
                   library_ms=time_ms(lib_fwd_bwd), library="SDPA forward + backward (autograd)",
                   library_back_to_back_ms=back_to_back_ms(lib_fwd_bwd),
                   bound=bound_ms(nbytes(q, k, v, kv, o, stat, do) + nbytes(q, k, v),
                                  10.0 * R * N * M * D),
                   # two passes form p twice: the floor of this design is twice the
                   # one-exp2 floor of any backward that recomputes p
                   **long_key_times("fused_attention_bwd", run, R * N * M,
                                    FA.bwd_resources(R, N, M, D, base2)),
                   ex2_per_pair=2)
        del q, k, v, do, o, stat, leaves, am, grads
        if name == "4aa_T1000":
            kern["fused_attention_fwd"], kern["fused_attention_bwd"] = fwd, bwd
        else:
            kern["fused_attention_fwd"][name], kern["fused_attention_bwd"][name] = fwd, bwd
    # row h's long form in the natural softmax at the T = 1000 shape
    S, Hc, N, D = B_SIM * L, H, T_SIM, C // H
    M = N + 1
    q = r(S, Hc, N, D, sc=D ** -0.5)
    k, v = r(S, Hc, M, D), r(S, Hc, M, D)
    kv = torch.ones(S, M, device=dev)
    kv[0, N // 2:N] = 0
    o, stat = FA.fused_attention_fwd(q, k, v, kv, base2=False)
    ro, rstat = FA.fused_attention_fwd_plain(q.float(), k.float(), v.float(), kv, base2=False)
    e_o = check("fused_attention_fwd[4aa_T1000_natural]", o, ro, 1e-2)
    e_s = check("fused_attention_fwd[4aa_T1000_natural].stat", stat, rstat, 1e-3)
    del ro, rstat
    am = ((kv - 1.0) * 1e9).to(bf)[:, None, None, :]
    run = lambda: FA.fused_attention_fwd(q, k, v, kv, base2=False)  # noqa: E731
    R = S * Hc
    kern["fused_attention_fwd"]["4aa_T1000_natural"] = dict(
        shape=f"{R} rows ({S} x {Hc} heads), {N} queries, {M} keys, D={D}, natural exp",
        max_abs_err=max(e_o[0], e_s[0]), tol={"o": e_o[1], "stat": e_s[1]}, ms=time_ms(run),
        back_to_back_ms=back_to_back_ms(run), resources=FA.fwd_resources(R, N, M, D, False),
        parent=parent_times("fused_attention", run),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=1.0)),
        bound=bound_ms(nbytes(q, k, v, kv, o, stat), 4.0 * R * N * M * D),
        ex2_floor_ms=ex2_floor_ms(R * N * M))
    del q, k, v, o, stat, am

    # the two stage backwards of the T = 1000 train step, as a whole
    M = B_SIM * T_SIM * L
    mask = torch.ones(B_SIM, T_SIM, L, device=dev)
    mask[0, :, -1] = 0
    mask[-1, 900:] = 0
    x, dout = r(M, C), r(M, C, dtype=f32)
    mods = [r(B_SIM, C, sc=0.3) for _ in range(3)]
    mlp_ws = [r(C, 4 * C, sc=C ** -0.5), r(4 * C, sc=0.1), r(4 * C, C, sc=(4 * C) ** -0.5),
              r(C, sc=0.1)]
    attn_ws = [r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), r(C, C, sc=C ** -0.5), r(C, sc=0.1),
               r(C), r(C)]
    dims = dict(B=B_SIM, T=T_SIM, L=L, num_heads=H)
    R, Mk, D = B_SIM * L * H, T_SIM + 1, C // H
    ops = {
        # six products of 2 * M * C * 4C: fc1, the fc2 recompute, two wgrads, two dgrads
        "row5b_adaln_mlp_bwd": (AM.adaln_mlp_bwd, AM.adaln_mlp_bwd_plain,
                                [x, *mods, *mlp_ws, dout], {}, 12.0 * M * C * 4 * C,
                                nbytes(x, dout, *mods, *mlp_ws) + M * C * 4
                                + nbytes(*mlp_ws) * 2 + B_SIM * 3 * C * 4,
                                ["dx", "dsh", "dsc", "dg", "dw1", "db1", "dw2", "db2"]),
        # qkv, out and their backward products (24 M C^2) and the attention
        # core forward (2 products) and backward (5)
        "time_attention_block_bwd": (TA.time_attention_block_bwd, TA.time_attention_block_bwd_plain,
                                     [x, *mods, *attn_ws, mask, dout], dims,
                                     24.0 * M * C * C + 14.0 * R * T_SIM * Mk * D,
                                     nbytes(x, dout, mask, *mods, *attn_ws) + M * C * 4
                                     + nbytes(*attn_ws) * 2 + B_SIM * 3 * C * 4,
                                     ["dx", "dsh", "dsc", "dg", "dwqkv", "dbqkv", "dwout",
                                      "dbout", "dbk", "dbv"]),
    }
    stages = {}
    for name, (op, plain, args, kw, flops, io, names) in ops.items():
        errs = held_composite(name, op, plain, args, kw, names)
        worst = max(errs, key=lambda n: errs[n][0] - errs[n][1])
        stages[name] = dict(rel_l2=errs[worst][0], tol=errs[worst][1], worst=worst,
                            rel_l2_vs_tol=errs, ms=time_ms(lambda: op(*args, **kw)),
                            parent=parent_times(("fused_attention", "fused_attention_bwd"),
                                                lambda: op(*args, **kw))
                            if name == "time_attention_block_bwd" else None,
                            plain_ms=time_ms(lambda: plain(*args, **kw), reps=5),
                            library_ms=None, bound=bound_ms(io, flops))
    emit({"phase": "long_bwd_kernels", "kernels": kern, "stages": stages,
          "rule": "stages: rel_l2(kernels) <= 2 * rel_l2(plain bf16) + 0.01 per output, "
                  "truth: plain f32"})
    return kern, stages


def train_cell(dev, phase, cfg, split, batch_size, pairs, bound_flops, extra):
    """A config trained through ``Trainer`` from its real init on the
    synthetic split: 2 warm-up and 10 timed steps, 20 steps on one fixed
    batch (fixed t and x0), a checkpoint round trip, and the launches of the
    kernel wrappers ``pairs`` (module, name). Emits the phase line (with
    ``extra``) and fails on non-finite numbers, a loss that does not fall, a
    changed checkpoint or a plain twin on the card (the caller checks the
    launches). Returns (launches, launches per step, (trainer, state, batch,
    generator))."""
    import numpy as np

    from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset, make_batch_iterator
    from mdgen_finetune_tpu_torch.training import Trainer

    it = make_batch_iterator(MDGenDataset(cfg, split), batch_size, seed=0)
    batches = [{k: torch.as_tensor(np.asarray(v), device=dev) for k, v in next(it).items()
                if k != "name"} for _ in range(12)]
    it.close()
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(0)
    gen = torch.Generator(device=dev).manual_seed(3)
    wrappers, twins = _counters(pairs)
    for fn in wrappers:
        fn.launches = 0
    for fn in twins:
        fn.cuda_calls = 0
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for b in batches[:2]:  # warm-up
        state, m = trainer.train_step(state, b, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    before = {fn.__name__: fn.launches for fn in wrappers}
    t0 = time.perf_counter()
    for b in batches[2:]:
        state, m = trainer.train_step(state, b, gen)
        metrics.append(m)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / 10
    per_step = {fn.__name__: (fn.launches - before[fn.__name__]) / 10 for fn in wrappers}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    fixed = []
    for _ in range(20):
        state, m = trainer.train_step(state, batches[0], torch.Generator(device=dev).manual_seed(5))
        fixed.append(m["loss"])
    fixed = [float(v) for v in fixed]

    saved = {k: v.detach().clone() for k, v in state.params.items()}
    saved_ema = {k: v.clone() for k, v in state.ema_params.items()}
    path = trainer.save_checkpoint(state)
    state, _ = trainer.train_step(state, batches[1], gen)
    state = trainer.restore_checkpoint(path, state)
    ckpt_ok = all(torch.equal(state.params[k], v) for k, v in saved.items()) and \
        all(torch.equal(state.ema_params[k], v) for k, v in saved_ema.items())
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    first5, last5 = sum(fixed[:5]) / 5, sum(fixed[-5:]) / 5
    T_, L_ = cfg.data.num_frames, cfg.data.crop
    emit({"phase": phase, "B": batch_size, "T": T_, "L": L_, "C": C,
          "layers": cfg.model.num_layers, "dtype": "bf16",
          "grad_checkpointing": cfg.model.grad_checkpointing, "ms_per_step": secs * 1e3,
          "bound_ms_per_step": bound_flops / PEAK_BF16_FLOPS * 1e3, "flops_per_step": bound_flops,
          "trajectories_per_s": batch_size / secs, "frames_per_s": batch_size * T_ / secs,
          "peak_memory_gb": peak_gb, "losses": losses, "grad_norms": norms,
          "fixed_batch_first5": first5, "fixed_batch_last5": last5,
          "checkpoint_round_trip": ckpt_ok, "launches_per_step": per_step,
          "launches": launches, "plain_calls_on_card": twin_calls,
          "last_metrics": {k: float(v) for k, v in metrics[-1].items()}, **extra})
    if not all(np.isfinite(losses + norms + fixed)):
        raise AssertionError(f"{phase}: non-finite loss or gradient norm")
    if not last5 < first5:
        raise AssertionError(f"{phase}: fixed-batch loss did not fall: {first5} -> {last5}")
    if not ckpt_ok:
        raise AssertionError(f"{phase}: checkpoint round trip changed the state")
    if any(twin_calls.values()):
        raise AssertionError(f"{phase}: plain twins ran on the card: {twin_calls}")
    return launches, per_step, (trainer, state, batches[0], gen)


def step_flops(Bc, Tc, Lc, layers=NL):
    """The trunk's products (qkv, out and the MLP of both stages: 16 C^2 per
    row) and its two attention cores (4 N (N+1) D per sequence and head), for
    one forward: ``(products, attention)``."""
    M = Bc * Tc * Lc
    products = layers * 2.0 * M * C * C * 16
    attention = layers * 4.0 * H * (C // H) * (Bc * Tc * Lc * (Lc + 1) + Bc * Lc * Tc * (Tc + 1))
    return products, attention


def phase_train_1000(dev):
    """The preset trained through ``Trainer`` at B = 8, T = 1000 from its
    real init on synthetic "AAGG" / "GHKL" trajectories of 2,000 frames
    (``train_cell``). The bound counts the trunk's products three times
    (forward, data and weight gradients) and its attention 3.5 times
    (forward 2 products, backward 5): no recompute, encoder and head left
    out."""
    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset

    cfg = train_1000_config(B_SIM)
    split = make_synthetic_dataset(cfg.data.data_dir, ["AAGG", "GHKL"], num_frames=2 * T_SIM,
                                   suffix=cfg.data.suffix)
    products, attention = step_flops(B_SIM, T_SIM, L)
    launches, per_step, run = train_cell(dev, "train_1000", cfg, split, B_SIM, WRAPPERS_1000,
                                         3 * products + 3.5 * attention, {})
    if min(per_step.values()) <= 0:
        raise AssertionError(f"train_1000: a kernel of the path never launched: {per_step}")
    return launches, per_step, run


def phase_train_cli(dev):
    """The training CLI on the card with the reference's T = 1000 command
    (scripts/train_4aa_forward_sim.sh) plus ``--batch_size 8 --epochs 1
    --steps_per_epoch 5 --val_batches 1``, on two synthetic 1,100-frame
    peptides; its checkpoint then drives one ``sim_inference`` window of
    1,000 frames (the CLI's default sampler, dopri5), parsed back."""
    import numpy as np

    from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data, train
    from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models

    data, out = SCRATCH / "cli_data", SCRATCH / "cli_sim"
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "GHKL", "--num_frames", "1100",
                     "--suffix", "_i100"])
    split = str(data / "split.csv")
    script = ["--sim_condition", "--train_split", split, "--val_split", split,
              "--data_dir", str(data), "--num_frames", "1000", "--prepend_ipa", "--abs_pos_emb",
              "--crop", "4", "--ckpt_freq", "40", "--val_repeat", "25", "--suffix", "_i100",
              "--epochs", "10000", "--grad_checkpointing", "--run_name", "forward_sim"]
    t0 = time.perf_counter()
    state = train.main(script + ["--batch_size", "8", "--epochs", "1", "--steps_per_epoch", "5",
                                 "--val_batches", "1", "--workdir", str(SCRATCH)])
    train_s = time.perf_counter() - t0
    run = SCRATCH / "forward_sim"
    log = [json.loads(x) for x in (run / "log.jsonl").read_text().splitlines()]
    ckpt = run / f"ckpt_{state.step}"
    t0 = time.perf_counter()
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(data), "--split", split,
                        "--out_dir", str(out), "--num_frames", "1000", "--num_rollouts", "1",
                        "--suffix", "_i100", "--device", str(dev)])
    sim_s = time.perf_counter() - t0
    meta = json.loads((out / "AAGG_meta.json").read_text())
    models = from_pdb_models(str(out / "AAGG.pdb"))
    emit({"phase": "train_cli", "steps": state.step, "log": log, "train_cli_s": train_s,
          "checkpoint": ckpt.name, "sim_meta": meta, "sim_cli_s": sim_s, "models": len(models)})
    for d in (data, out, run):
        shutil.rmtree(d, ignore_errors=True)
    vals = [v for m in log for v in m.values()]
    if state.step != 5 or not any("val_loss" in m for m in log) or not np.isfinite(vals).all():
        raise AssertionError(f"train_cli: {state.step} steps, log {log}")
    if len(models) != T_SIM or meta["frames"] != T_SIM:
        raise AssertionError(f"train_cli: sim_inference wrote {len(models)} models")


# ---------------------------------------------------------------------------
# the ATLAS crop-256 preset (config.preset_atlas)
# ---------------------------------------------------------------------------

L_ATLAS, T_ATLAS, B_ATLAS = 256, 250, 1  # crop 256, 250 frames, batch 1
ATLAS_PROTEINS = (("atlas_300", 300), ("atlas_200", 200))  # cropped; zero-padded
ATLAS_PAD = L_ATLAS - 200  # the 200-residue protein's padding at crop 256


def atlas_config(method="dopri5", steps=None, layers=None):
    """The ATLAS preset (``preset_atlas``: crop 256, 250 frames, batch 1,
    suffix _i40, sim_condition) at full width: 5 x 384, 16 heads of D = 24,
    prepend-IPA 4 x 32, abs_pos_emb, bf16; Adam lr 1e-4, clip 1.0, EMA
    0.999 on the synthetic replicas of ``atlas_data``."""
    from mdgen_finetune_tpu_torch.config import (ModelConfig, TrainConfig, TransportConfig,
                                                 preset_atlas)

    cfg = preset_atlas(
        model=ModelConfig(num_layers=layers or NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        transport=TransportConfig(sampling_method=method, inference_steps=steps or STEPS),
        train=TrainConfig(batch_size=B_ATLAS, lr=1e-4, grad_clip=1.0, ema=True, ema_decay=0.999),
        workdir=str(SCRATCH), run_name="atlas")
    return cfg.replace(data=dataclasses.replace(cfg.data, data_dir=str(SCRATCH / "atlas_data"),
                                                num_frames=T_ATLAS, crop=L_ATLAS))


def atlas_data():
    """Synthetic trajectories in the ATLAS layout (``{name}_R{1,2,3}_i40.npy``,
    300 frames each; no ATLAS dataset is in the repository): a protein of
    300 residues, which the crop cuts to 256, listed first (``sim_inference``
    samples the first), and one of 200, which it pads. Written once."""
    import numpy as np

    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset

    d = SCRATCH / "atlas_data"
    if not (d / "split.csv").exists():
        rng = np.random.default_rng(61)
        aa = list("ACDEFGHIKLMNPQRSTVWY")
        prots = [(name, "".join(rng.choice(aa, n))) for name, n in ATLAS_PROTEINS]
        make_synthetic_dataset(str(d), prots, num_frames=300, suffix="_i40", replicas=(1, 2, 3))
    return d, str(d / "split.csv")


def phase_atlas_kernels(dev):
    """The ATLAS path's kernels against their plain twins (f32 on the same
    inputs) at its shapes: ``blocked_attention_bwd`` (row j) in the residue
    view (250 sequences of N = 256), the frame view (256 sequences of
    N = 250), at N = 129 and at its limit; ``tiled_attention`` and
    ``rope_attention`` as the residue stage's core (the route keeps JAX's
    gate, tiled above MAX_L = 8; both timed); ``ipa_attention`` (row c,
    ``ipa_entry``: SDPA on augmented heads; the parent's bits asserted in
    the streaming form, the parent's error recorded in the tensor-core
    form) in its tensor-core form at L = 256 over the 100-point t grid of
    one Euler-100 sample and at B = 1 (dopri5, training), and at
    (Ch, Pq, Pv) = (16, 4, 6), each with translations across +-40 A and the
    56 padded residues masked; in its streaming form at L = 4;
    then ``residue_rows_block`` (row 7) and the whole stage backward
    (``attention_stage_bwd``, row 8) in both views under the composition
    rule. The residues past 200 are padding (mask 0), as for a 200-residue
    protein. Library: SDPA on the RoPE'd heads (forward; forward + backward
    through autograd for the backward core)."""
    import math

    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import blocked_attention_bwd as BA
    from mdgen_finetune_tpu_torch.ops import fused_layer_bwd as FLB
    from mdgen_finetune_tpu_torch.ops import time_attention as TA
    from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention, rope_attention_plain
    from mdgen_finetune_tpu_torch.ops import tiled_attention as TLA
    from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention

    g = torch.Generator(device=dev).manual_seed(71)
    bf, f32 = torch.bfloat16, torch.float32
    D = C // H

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(dtype)

    def qkv_case(view):
        qkv = r(*view, 3 * C)
        qkv[..., :C] *= 0.5 * D ** -0.5 * math.log2(math.e)  # the trunk's folded q scale
        return qkv

    Mrows = B_ATLAS * T_ATLAS * L_ATLAS
    mask = torch.ones(B_ATLAS, T_ATLAS, L_ATLAS, device=dev)
    mask[:, :, L_ATLAS - ATLAS_PAD:] = 0
    rows, frames = (B_ATLAS * T_ATLAS, L_ATLAS, 1), (B_ATLAS, T_ATLAS, L_ATLAS)
    bk, bv = r(C), r(C)
    out = {}

    # ---- blocked_attention_bwd ----
    limit = BA.max_keys(D)
    # dout of order 1 and, as in a real step, ~1e-6 (held to its own scale:
    # the kernel's gradients must not underflow)
    cases = {"rows_N256": (rows, 1.0), "frames_N250": (frames, 1.0), "N129": ((1, 129, 64), 1.0),
             f"N{limit}_limit": ((1, limit, 64), 1.0), "rows_N256_dout1e-6": (rows, 1e-6)}
    blocked = {}
    for name, (view, dsc) in cases.items():
        qkv, do = qkv_case(view), r(*view, C, sc=dsc)
        mk = mask.view(view) if view in (rows, frames) else torch.ones(view, device=dev)
        if view not in (rows, frames):
            mk[0, view[1] // 2:, ::3] = 0  # masked keys
        got = BA.blocked_attention_bwd(qkv, do, bk, bv, mk, num_heads=H)
        again = BA.blocked_attention_bwd(qkv, do, bk, bv, mk, num_heads=H)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"blocked_attention_bwd[{name}]: two calls differ")
        del again
        ref = BA.blocked_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mk,
                                             num_heads=H)
        own = [1.0 if dsc == 1.0 else b.abs().max().item() for b in ref]
        errs = [check(f"blocked_attention_bwd[{name}].{n}", a.float() / s, b / s, 1e-2)
                for n, a, b, s in zip(("dqkv", "dbk", "dbv"), got, ref, own)]
        del ref
        G_, N_, I_ = view
        S_ = G_ * I_
        entry = dict(shape=f"{S_} sequences x {H} heads, N = {N_} ({N_ + 1} keys), D = {D}",
                     max_abs_err=max(e * s for (e, _), s in zip(errs, own)),
                     tol={n: t * s for n, (_, t), s in zip(("dqkv", "dbk", "dbv"), errs, own)},
                     smem_bytes=BA.smem_bytes(N_, D))
        if dsc != 1.0:
            entry["dout_scale"] = dsc
        if view in (rows, frames) and dsc == 1.0:
            q, k, v, am = sdpa_inputs(qkv, bk, bv, mk, H)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            dsd = do.permute(0, 2, 1, 3).reshape(S_, N_, H, D).transpose(1, 2).contiguous()

            def lib_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=math.log(2))
                return torch.autograd.grad(o, leaves, dsd)

            run = lambda: BA.blocked_attention_bwd(qkv, do, bk, bv, mk, num_heads=H)  # noqa: E731
            entry.update(
                ms=time_ms(run), back_to_back_ms=back_to_back_ms(run),
                parent=parent_times("blocked_attention_bwd", run),
                resources=BA.resources(N_, D),
                plain_ms=time_ms(lambda: BA.blocked_attention_bwd_plain(qkv, do, bk, bv, mk,
                                                                        num_heads=H), reps=5),
                library_ms=time_ms(lib_fwd_bwd), library="SDPA forward + backward (autograd)",
                library_back_to_back_ms=back_to_back_ms(lib_fwd_bwd),
                # the least a backward that recomputes P does: q.k, dO.v, p^T.dO, ds^T.q, ds.k
                bound=bound_ms(nbytes(qkv, do, mk, bk, bv) + qkv.numel() * 2,
                               10.0 * S_ * H * N_ * (N_ + 1) * D))
            del q, k, v, am, leaves, dsd
        blocked[name] = entry
    out["blocked_attention_bwd"] = dict(blocked["rows_N256"], frames_N250=blocked["frames_N250"],
                                        N129=blocked["N129"], limit=blocked[f"N{limit}_limit"],
                                        dout_1e6=blocked["rows_N256_dout1e-6"])

    # ---- the residue stage's forward core at L = 256: tiled (the route) and rope ----
    qkv = qkv_case(rows)
    mk = mask.view(rows)
    ref = rope_attention_plain(qkv.float(), bk.float(), bv.float(), mk, num_heads=H, base2=True)
    e_t = check("tiled_attention[atlas_rows]", tiled_attention(qkv, bk, bv, mk, num_heads=H), ref,
                1e-2)
    e_r = check("rope_attention[atlas_rows]",
                rope_attention(qkv, bk, bv, mk, num_heads=H, base2=True), ref, 1e-2)
    del ref
    q, k, v, am = sdpa_inputs(qkv, bk, bv, mk, H)
    run = lambda: tiled_attention(qkv, bk, bv, mk, num_heads=H)  # noqa: E731
    core = dict(shape=f"{rows[0]} sequences x {H} heads, {L_ATLAS} queries, {L_ATLAS + 1} keys, "
                      f"D = {D}",
                max_abs_err=e_t[0], tol=e_t[1], rope_max_abs_err=e_r[0], ms=time_ms(run),
                **long_key_times("tiled_attention", run, rows[0] * H * L_ATLAS * (L_ATLAS + 1),
                                 TLA.resources(rows[0], L_ATLAS, 1, H, D)),
                rope_attention_ms=time_ms(lambda: rope_attention(qkv, bk, bv, mk, num_heads=H,
                                                                 base2=True)),
                plain_ms=time_ms(lambda: rope_attention_plain(qkv, bk, bv, mk, num_heads=H,
                                                              base2=True), reps=5),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=math.log(2))),
                bound=bound_ms(nbytes(qkv, bk, bv, mk) + qkv.numel() // 3 * 2,
                               4.0 * rows[0] * H * L_ATLAS * (L_ATLAS + 1) * D))
    out["residue_core_atlas"] = core
    del q, k, v, am, qkv

    # ---- ipa_attention: the tensor-core form at L = 256 over the Euler-100 t
    # grid (100 elements) and at B = 1 (dopri5, training), translations
    # across +-40 A, the 56 padded residues masked; at (Ch, Pq, Pv) =
    # (16, 4, 6); the streaming form at L = 4 ----
    ipa = {}
    for name, (Bn, Lc, widths, spread) in (("L256", (STEPS * B_ATLAS, L_ATLAS, (32, 8, 8), 40.0)),
                                           ("L256_B1", (B_ATLAS, L_ATLAS, (32, 8, 8), 40.0)),
                                           ("L4", (STEPS, 4, (32, 8, 8), None)),
                                           ("L256_w16_4_6", (STEPS * B_ATLAS, L_ATLAS, (16, 4, 6),
                                                             40.0))):
        def pad_tail(m, Lc=Lc):
            m[:, Lc - Lc * ATLAS_PAD // L_ATLAS:] = 0

        ipa[name] = ipa_entry(dev, f"atlas {name}", Bn, Lc, widths, pad_tail, seed=Lc + Bn,
                              plain_reps=5, spread=spread)
    out["ipa_attention"] = dict(ipa["L256"], L256_B1=ipa["L256_B1"], L4=ipa["L4"],
                                L256_w16_4_6=ipa["L256_w16_4_6"])

    # ---- row 7 (residue_rows_block) and row 8 (the stage backwards) as a whole ----
    x, dout = r(Mrows, C), r(Mrows, C, dtype=f32)
    mods = [r(B_ATLAS, C, sc=0.3) for _ in range(3)]
    ws = [r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), r(C, C, sc=C ** -0.5), r(C, sc=0.1),
          r(C), r(C)]
    dims = dict(B=B_ATLAS, T=T_ATLAS, L=L_ATLAS, num_heads=H)
    f_core = 4.0 * rows[0] * H * L_ATLAS * (L_ATLAS + 1) * D
    stages = {}
    errs = held_composite("residue_rows_block", lambda *a, **k: (TA.residue_rows_block(*a, **k),),
                          lambda *a, **k: (TA.residue_rows_block_plain(*a, **k),),
                          [x, *mods, *ws, mask], dims, ["out"])
    stages["row7_residue_rows_block"] = dict(
        rel_l2=errs["out"][0], tol=errs["out"][1],
        ms=time_ms(lambda: TA.residue_rows_block(x, *mods, *ws, mask, **dims)),
        parent=parent_times("tiled_attention",
                            lambda: TA.residue_rows_block(x, *mods, *ws, mask, **dims)),
        plain_ms=time_ms(lambda: TA.residue_rows_block_plain(x, *mods, *ws, mask, **dims), reps=5),
        library_ms=None,
        bound=bound_ms(nbytes(x, mask, *mods, *ws) + Mrows * C * 2,
                       2.0 * Mrows * C * 4 * C + f_core))
    mod9 = r(B_ATLAS, 9 * C, sc=0.3)
    names = ["dx", "dmod", "dwqkv", "dbqkv", "dwout", "dbout", "dbk", "dbv"]
    for name, view, j in (("row8_rows_view", rows, 0), ("row8_frames_view", frames, 3)):
        def op(X, dX, mod, *w, mask, view=view, j=j):
            dmod = torch.zeros(mod.shape[0], 9 * C, device=dev)
            dx, grads = FLB.attention_stage_bwd(X, dX, mod, j, w, mask, view, H, dmod,
                                                short=False)
            return (dx, dmod[:, j * C:(j + 3) * C], *grads)

        def plain(*a, **k):
            return with_twins(lambda: op(*a, **k))

        n0 = BA.blocked_attention_bwd.launches
        errs = held_composite(name, op, plain, [x, dout, mod9, *ws], dict(mask=mask), names)
        if BA.blocked_attention_bwd.launches != n0 + 1:
            raise AssertionError(f"{name}: the stage did not take blocked_attention_bwd")
        worst = max(errs, key=lambda n: errs[n][0] - errs[n][1])
        N_ = view[1]
        stages[name] = dict(
            rel_l2=errs[worst][0], tol=errs[worst][1], worst=worst, rel_l2_vs_tol=errs,
            ms=time_ms(lambda: op(x, dout, mod9, *ws, mask=mask)),
            parent=parent_times("tiled_attention", lambda: op(x, dout, mod9, *ws, mask=mask)),
            plain_ms=with_twins(lambda: time_ms(lambda: op(x, dout, mod9, *ws, mask=mask),
                                                reps=3)),
            library_ms=None,
            # qkv, out and their data and weight products (24 M C^2), the
            # core's forward (2 products) and backward (5)
            bound=bound_ms(nbytes(x, dout, mask, mod9, *ws) + Mrows * C * 4 + nbytes(*ws) * 2,
                           24.0 * Mrows * C * C
                           + 14.0 * (Mrows // N_) * H * N_ * (N_ + 1) * D))
    emit({"phase": "atlas_kernels", "kernels": out, "stages": stages,
          "rule": "stages: rel_l2(kernels) <= 2 * rel_l2(plain bf16) + 0.01 per output, "
                  "truth: plain f32; kernels: max abs err <= 0.01 x max(1, max |plain f32|)"})
    return out


def atlas_launch_checks(name, launches, twin_calls, out, mask, want):
    """Finite samples, ideal backbone bonds on the real residues, the plain
    twins idle and the launches ``want`` (wrapper: count) exactly."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    n_ca, ca_c = bonds(out.cpu(), mask.cpu())
    dev_nca, dev_cac = (n_ca - 1.458).abs().max().item(), (ca_c - 1.522).abs().max().item()
    if dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"{name}: backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")
    if any(twin_calls.values()):
        raise AssertionError(f"{name}: plain twins ran on the card: {twin_calls}")
    wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if wrong:
        raise AssertionError(f"{name}: launches (got, expected): {wrong}")
    return dict(n_ca_mean=n_ca.mean().item(), ca_c_mean=ca_c.mean().item(),
                n_ca_max_dev=dev_nca, ca_c_max_dev=dev_cac)


def phase_sim_atlas(dev):
    """The ATLAS preset sampled on the card (L = 256, T = 250, B = 1, a
    200-residue protein padded to 256, seeded random weights): one velocity
    evaluation on the card against the CPU in f32; ``InferenceEngine.sample``
    with Euler-100 after a warm-up (frames/s); the preset's dopri5 (accepted
    and rejected steps, evaluations); bonds and launches for both."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.ops import ipa_attention as IA
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    cfg = atlas_config("euler")
    eng, sd = random_engine(dev, cfg, seed=73)
    atom14, seqres, mask = make_inputs(B_ATLAS, 74, "cpu", length=L_ATLAS, pad=ATLAS_PAD)
    wrappers, twins = fwd_counters()

    def reset():
        for fn in wrappers:
            fn.launches = 0
        for fn in twins:
            fn.cuda_calls = 0
        IA.ipa_attention.forms = [0, 0, 0, 0]

    def read():
        return ({fn.__name__: fn.launches for fn in wrappers},
                {fn.__name__: fn.cuda_calls for fn in twins})

    # one velocity evaluation, card against CPU (the batch featurized once)
    cpu = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)), sd,
                          device="cpu")
    feats = cpu._expand_frame0(atom14, seqres, mask)
    zs = torch.randn(B_ATLAS, T_ATLAS, L_ATLAS, cfg.latent_dim,
                     generator=torch.Generator().manual_seed(75))
    vel, secs_eval = {}, {}
    for name, e in (("cuda", eng), ("cpu", cpu)):
        d = e.device
        kw = prep_batch(e.cfg, {k: v.to(d) for k, v in feats.items()})["model_kwargs"]
        reset()
        t0 = time.perf_counter()
        v = e.model.forward_inference(zs.to(d), torch.full((1,), 0.4, device=d), kw["mask"],
                                      start_frames=kw["start_frames"], x_cond=kw["x_cond"],
                                      x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
        vel[name] = v.float().cpu()
        secs_eval[name] = time.perf_counter() - t0
        if name == "cuda":
            per_eval, _ = read()
    del cpu
    rel = ((vel["cuda"] - vel["cpu"]).norm() / vel["cpu"].norm()).item()
    if not rel <= 5e-2 or not torch.isfinite(vel["cuda"]).all():
        raise AssertionError(f"sim_atlas: card vs CPU velocity: relative L2 {rel} > 5e-2")
    want_eval = {"tiled_attention": 2 * NL, "rope_attention": NL, "ipa_attention": NL}
    if any(per_eval[k] != v for k, v in want_eval.items()):
        raise AssertionError(f"sim_atlas: launches per velocity evaluation {per_eval}")

    atom14, seqres, mask = atom14.to(dev), seqres.to(dev), mask.to(dev)
    gen = torch.Generator(device=dev).manual_seed(76)
    batch = eng._expand_frame0(atom14, seqres, mask)
    eng.sample(batch, gen)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, twin_calls = read()
    # row c's forms: the encoder over the t grid (100 x 256) on the tensor cores
    launches["ipa_attention.forms"] = list(IA.ipa_attention.forms)
    if launches["ipa_attention.forms"] != [0, 0, 0, NL]:
        raise AssertionError(f"sim_atlas: ipa_attention's forms {launches['ipa_attention.forms']}")
    assert out.shape == (B_ATLAS, T_ATLAS, L_ATLAS, 14, 3)
    # Euler: the encoder runs once over the t grid, the trunk once per step
    checks = atlas_launch_checks("sim_atlas", launches, twin_calls, out, mask,
                                 {"tiled_attention": 2 * NL * STEPS, "rope_attention": NL,
                                  "ipa_attention": NL})
    products, attention = step_flops(B_ATLAS, T_ATLAS, L_ATLAS)
    flops_step = products + attention + 2.0 * B_ATLAS * T_ATLAS * L_ATLAS * cfg.latent_dim * C * 2
    e5 = InferenceEngine(atlas_config("dopri5"), sd, device=dev)
    b1 = e5._expand_frame0(atom14, seqres, mask)
    reset()
    t0 = time.perf_counter()
    o5, _ = e5.sample(b1, gen)
    torch.cuda.synchronize()
    s5 = time.perf_counter() - t0
    l5, tc5 = read()
    n = e5.last_counts["evals"]
    l5["ipa_attention.forms"] = list(IA.ipa_attention.forms)
    if l5["ipa_attention.forms"] != [0, 0, 0, NL * n]:  # (1, 256) each evaluation
        raise AssertionError(f"sim_atlas dopri5: ipa_attention's forms {l5['ipa_attention.forms']}")
    dopri5 = dict(sample_s=s5, **e5.last_counts, launches=l5, **atlas_launch_checks(
        "sim_atlas dopri5", l5, tc5, o5, mask,
        {"tiled_attention": 2 * NL * n, "rope_attention": NL * n, "ipa_attention": NL * n}))
    del e5
    emit({"phase": "sim_atlas", "B": B_ATLAS, "T": T_ATLAS, "L": L_ATLAS, "C": C, "layers": NL,
          "valid_residues": L_ATLAS - ATLAS_PAD, "dtype": "bf16",
          "step_cuda_vs_cpu": {"rel_l2": rel, "tol": 5e-2,
                               "velocity_norm_cpu": vel["cpu"].norm().item(),
                               "seconds": secs_eval, "launches_per_eval": per_eval},
          "euler_steps": STEPS, "sample_s": secs, "frames_per_s": B_ATLAS * T_ATLAS / secs,
          "ms_per_step": secs / STEPS * 1e3,
          "bound_ms_per_step": flops_step / PEAK_BF16_FLOPS * 1e3, "flops_per_step": flops_step,
          "launches_per_sample": launches, "plain_calls_on_card": twin_calls, **checks,
          "b1_dopri5": dopri5})
    return launches, (eng, batch, gen)


ATLAS_WRAPPERS = WRAPPERS_1000 + (("blocked_attention_bwd", "blocked_attention_bwd"),)


def phase_train_atlas(dev):
    """The ATLAS preset trained through ``Trainer`` at B = 1 (``train_cell``)
    on the synthetic replicas; per step 10 launches of
    ``blocked_attention_bwd`` (5 layers x 2 stages) and none of
    ``rope_attention_bwd`` or the ``fused_attention`` kernels."""
    _, split = atlas_data()
    products, attention = step_flops(B_ATLAS, T_ATLAS, L_ATLAS)
    launches, per_step, run = train_cell(dev, "train_atlas", atlas_config(), split, B_ATLAS,
                                         ATLAS_WRAPPERS, 3 * products + 3.5 * attention,
                                         {"valid_residues": "200 or 256 (the synthetic replicas)"})
    want = {"blocked_attention_bwd": 2 * NL, "rope_attention_bwd": 0, "fused_attention_fwd": 0,
            "fused_attention_bwd": 0, "tiled_attention": 4 * NL, "rope_attention": NL,
            "ipa_attention": NL}
    wrong = {k: (per_step[k], v) for k, v in want.items() if per_step[k] != v}
    if wrong or min(per_step[k] for k in ("adaln_linear", "linear_bwd", "modln_bwd")) <= 0:
        raise AssertionError(f"train_atlas: launches per step (got, expected): {wrong}, {per_step}")
    return launches, per_step, run


def phase_atlas_cli(dev):
    """The ATLAS path through the CLIs on the card: ``train`` with
    ``--atlas --crop 256 --num_frames 250 --batch_size 1 --prepend_ipa
    --abs_pos_emb --sim_condition --suffix _i40`` for 3 steps on the
    synthetic replicas, then ``sim_inference`` writes one 250-frame window
    of the 300-residue protein (cropped to 256) from that checkpoint (the
    CLI's default sampler, dopri5), parsed back."""
    import numpy as np

    from mdgen_finetune_tpu_torch.cli import sim_inference, train
    from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models

    data, split = atlas_data()
    out = SCRATCH / "atlas_sim"
    t0 = time.perf_counter()
    state = train.main(["--atlas", "--crop", str(L_ATLAS), "--num_frames", str(T_ATLAS),
                        "--batch_size", str(B_ATLAS), "--prepend_ipa", "--abs_pos_emb",
                        "--sim_condition", "--suffix", "_i40", "--train_split", split,
                        "--val_split", split, "--data_dir", str(data), "--epochs", "1",
                        "--steps_per_epoch", "3", "--val_batches", "1", "--workdir",
                        str(SCRATCH), "--run_name", "atlas_cli", "--device", str(dev)])
    train_s = time.perf_counter() - t0
    run = SCRATCH / "atlas_cli"
    log = [json.loads(x) for x in (run / "log.jsonl").read_text().splitlines()]
    ckpt = run / f"ckpt_{state.step}"
    t0 = time.perf_counter()
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(data), "--split", split,
                        "--out_dir", str(out), "--num_frames", str(T_ATLAS), "--num_rollouts",
                        "1", "--suffix", "_i40", "--device", str(dev)])
    sim_s = time.perf_counter() - t0
    name = ATLAS_PROTEINS[0][0]
    meta = json.loads((out / f"{name}_meta.json").read_text())
    models = from_pdb_models(str(out / f"{name}.pdb"))
    residues = sorted({len(a) for a, _ in models})
    emit({"phase": "atlas_cli", "steps": state.step, "log": log, "train_cli_s": train_s,
          "checkpoint": ckpt.name, "sim_meta": meta, "sim_cli_s": sim_s, "models": len(models),
          "residues_per_model": residues, "pdb_bytes": (out / f"{name}.pdb").stat().st_size})
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(run, ignore_errors=True)
    vals = [v for m in log for v in m.values()]
    if state.step != 3 or not any("val_loss" in m for m in log) or not np.isfinite(vals).all():
        raise AssertionError(f"atlas_cli: {state.step} steps, log {log}")
    if len(models) != T_ATLAS or residues != [L_ATLAS] or meta["frames"] != T_ATLAS:
        raise AssertionError(f"atlas_cli: sim_inference wrote {len(models)} models of "
                             f"{residues} residues")


# ---------------------------------------------------------------------------
# the modular layer (interleave_ipa, hyena, no_rope): sampling
# ---------------------------------------------------------------------------
MODULAR_FLAGS = ("interleave_ipa", "hyena", "no_rope")
# the modular path's kernel wrappers, as (module, wrapper)
MODULAR_WRAPPERS = (("adaln_linear", "adaln_linear"), ("rope_attention", "rope_attention"),
                    ("ipa_attention", "ipa_attention"), ("tiled_attention", "tiled_attention"),
                    ("fused_attention", "fused_attention_fwd"))


# the counts of natural-softmax frame attention (TPU rows 11a / 11b), as
# (wrapper attribute): rope_attention's long body, tiled_attention; no
# modular config launches either (interleave_ipa's frame stage is the fused
# base-2 layer's, hyena's a convolution, no_rope's fused_attention)
NATURAL_FRAME_COUNTS = ("long_natural", "natural")


def modular_config(flag, frames=T, method="euler", steps=None, layers=NL):
    """The flagship width (5 x 384, 16 heads, prepend-IPA 4 x 32,
    abs_pos_emb, sim_condition, bf16) with one modular flag: at T = 100 (the
    flagship's data config) or at T = 1000 (``preset_4aa_sim``)."""
    base = sim_config(method, steps) if frames == T_SIM else flagship_config(method, steps)
    return base.replace(model=dataclasses.replace(base.model, num_layers=layers, **{flag: True}))


def modular_launches_per_eval(cfg):
    """The kernel launches of one velocity evaluation of a modular config,
    derived from the code (``LatentMDGen.forward_inference``): the embed and
    the head (1 ``adaln_linear`` each); per layer the IPA with
    ``interleave_ipa`` (2 ``adaln_linear`` + 1 ``ipa_attention``), each
    attention stage (2 ``adaln_linear`` + its core: ``rope_attention`` at
    L <= 8 and T <= 256, ``tiled_attention`` above, ``fused_attention_fwd``
    without RoPE), Hyena's in- and out-projections (2 ``adaln_linear``, its
    convolutions are ``torch.fft``) and ``adaln_mlp`` (2 ``adaln_linear``);
    the prepend encoder per layer 6 ``adaln_linear``, 1 ``ipa_attention``
    and its residue core (``fused_attention_fwd`` under ``no_rope``).
    ``interleave_ipa`` runs the fused layer after its IPA (``trunk_layer``:
    the same counts, both cores at base 2: the residue stage in
    ``rope_attention``'s short base-2 body, the frame stage in its long
    body at T <= 256 and ``tiled_attention`` above); ``hyena`` runs the
    residue stage in the natural short body (TPU row 12).
    ``adaln_mlp`` counts its calls (each is 2 of the ``adaln_linear``)."""
    m = cfg.model
    n = {k: 0 for _, k in MODULAR_WRAPPERS}
    NLc, Tc = m.num_layers, cfg.data.num_frames
    dense = "fused_attention_fwd"
    n["adaln_linear"] = 2 + NLc * (6 + 2 * m.interleave_ipa) + 6 * NLc
    n["ipa_attention"] = NLc * (1 + m.interleave_ipa)
    n[dense if m.no_rope else "rope_attention"] += 2 * NLc  # the residue stage and the encoder
    if m.no_rope:
        n[dense] += NLc
    elif not m.hyena:
        n["rope_attention" if Tc <= 256 else "tiled_attention"] += NLc
    return n, {"adaln_mlp": NLc}


def modular_sample(dev, name, cfg, batch_size, seed, pad=1):
    """``InferenceEngine.sample`` of a modular config after a warm-up: frames
    per second, seconds per sample, ideal bonds, the launches per sample
    exactly as derived and no plain twin on the card."""
    eng, _ = random_engine(dev, cfg, seed=seed)
    atom14, seqres, mask = make_inputs(batch_size, seed + 1, dev, pad=pad)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    batch = eng._expand_frame0(atom14, seqres, mask)
    eng.sample(batch, gen)  # warm-up
    torch.cuda.synchronize()
    wrappers, twins = _counters(MODULAR_WRAPPERS)
    for fn in wrappers:
        fn.launches = 0
        # adaln_linear's routes, fused_attention_fwd's forms, rope_attention's bodies
        for part in ("routes", "forms", "bodies"):
            if hasattr(fn, part):
                setattr(fn, part, [0] * len(getattr(fn, part)))
        # the natural frame attention's launches (TPU rows 11a / 11b)
        for part in NATURAL_FRAME_COUNTS:
            if hasattr(fn, part):
                setattr(fn, part, 0)
    for fn in twins:
        fn.cuda_calls = 0
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    by_part = {f"{fn.__name__}.{part}": list(getattr(fn, part)) for fn in wrappers
               for part in ("routes", "forms", "bodies") if hasattr(fn, part)}
    natural = {f"{fn.__name__}.{part}": getattr(fn, part) for fn in wrappers
               for part in NATURAL_FRAME_COUNTS if hasattr(fn, part)}
    if len(natural) != len(NATURAL_FRAME_COUNTS) or any(natural.values()):
        raise AssertionError(f"{name}: natural frame attention launched (rows 11a / 11b have "
                             f"no modular path; expected 0 of each): {natural}")
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
    evals = eng.last_counts["evals"]
    per_eval, calls = modular_launches_per_eval(cfg)
    want = {k: v * evals for k, v in per_eval.items()}
    checks = atlas_launch_checks(name, launches, twin_calls, out, mask, want)
    Tc = cfg.data.num_frames
    emit({"phase": name, "B": batch_size, "T": Tc, "L": L, "C": C, "layers": cfg.model.num_layers,
          "flag": next(f for f in MODULAR_FLAGS if getattr(cfg.model, f)),
          "sampler": f"{cfg.transport.sampling_method}-{cfg.transport.inference_steps}",
          "dtype": "bf16", "sample_s": secs, "frames_per_s": batch_size * Tc / secs,
          "s_per_sample": secs / batch_size, "ms_per_eval": secs / evals * 1e3, **eng.last_counts,
          "launches_per_sample": launches, "launches_per_eval_derived": per_eval,
          "launches_by_route_or_form": by_part, "natural_frame_launches": natural,
          "calls_per_eval_derived": calls, "plain_calls_on_card": twin_calls, **checks})
    return {**launches, **by_part, **natural}, (eng, batch, gen)


def max_logit(qkv, bk, mask, Hc):
    """The largest attendable logit of a natural-softmax attention over
    (G, N, I, 3C) qkv (RoPE'd q.k with the bias key)."""
    q, k, _, am = sdpa_inputs(qkv.float(), bk.float(), bk.float(), mask, Hc)
    return (q @ k.transpose(-1, -2) + am).amax().item()


def phase_modular_kernels(dev):
    """The modular layer's cores against their plain twins in f32 on the
    same inputs, at its shapes, with q carrying head_dim**-0.5 only (the
    natural softmax): ``rope_attention(base2=False)`` at row 12's shape
    (6,400 frames of L = 4) and row 11a's (B = 64, T = 100, L = 4);
    ``tiled_attention(base2=False)`` (row 11b) at B = 8, T = 1000, L = 4, at
    the ATLAS residue view (250 frames of L = 256) and with q scaled 400x,
    where the logits reach ~1e3 and exp without the max overflows f32 (there
    a logit moves by ~2 when the kernel rounds the RoPE'd q and k to bf16,
    as the JAX kernel does, so the reference is the plain math with that
    rounding, ``rope_attention_math(stage=bf16)``; q and k are nonzero in the
    first half of each head's lanes only, where RoPE is one product per
    lane, so that both round the same f32 values; the error against the
    plain f32 twin is reported beside it);
    ``fused_attention_fwd(base2=False)`` at the ``no_rope`` frame and residue
    views; the repaired ``blocked_attention_bwd`` at both ATLAS views with
    RoPE'd q ~ 2e5 and k ~ 1e-5 (beyond fp16's range, logits O(1)); and TPU
    row 11c, the fused trunk's short-route frame block, as a whole at the
    flagship shape under the composition rule. Times: kernel, plain twin,
    SDPA on the RoPE'd heads; bounds from these inputs."""
    import math

    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import blocked_attention_bwd as BA
    from mdgen_finetune_tpu_torch.ops import fused_attention as FA
    from mdgen_finetune_tpu_torch.ops.fused_attention import (fused_attention_fwd,
                                                              fused_attention_fwd_plain)
    from mdgen_finetune_tpu_torch.ops.rope_attention import (rope_attention, rope_attention_math,
                                                             rope_attention_plain)
    from mdgen_finetune_tpu_torch.ops import tiled_attention as TLA
    from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention, tiled_attention_plain

    g = torch.Generator(device=dev).manual_seed(81)
    bf = torch.bfloat16
    D = C // H

    def qkv_case(view, q_scale=1.0, k_scale=1.0):
        qkv = torch.randn(*view, 3 * C, generator=g, device=dev)
        qkv[..., :C] *= D ** -0.5 * q_scale
        qkv[..., C:2 * C] *= k_scale
        if q_scale == 400.0:  # q and k in the first half of each head's lanes only
            qkv.view(*view, 3, H, 2, D // 2)[..., :2, :, 1, :] = 0
        return qkv.to(bf)

    bk, bv = (torch.randn(C, generator=g, device=dev).to(bf) for _ in range(2))
    rows, frames = (B * T, L, 1), (B, T, L)
    out = {}
    cases = {"row12_residue": (rope_attention, rope_attention_plain, rows, 1.0),
             "row11a_frames": (rope_attention, rope_attention_plain, frames, 1.0),
             "row11b_frames_T1000": (tiled_attention, tiled_attention_plain, (B_SIM, T_SIM, L), 1.0),
             "row11b_atlas_residue": (tiled_attention, tiled_attention_plain,
                                      (B_ATLAS * T_ATLAS, L_ATLAS, 1), 1.0),
             "row11b_large_logits": (tiled_attention, tiled_attention_plain, (2, T_SIM, L), 400.0)}
    bk_half = bk.clone()
    bk_half.view(H, 2, D // 2)[:, 1] = 0
    for name, (kern, plain, view, qs) in cases.items():
        qkv = qkv_case(view, qs)
        bk_c = bk if qs == 1.0 else bk_half
        mask = torch.ones(view, device=dev)
        if view == rows:
            mask[:T, -1] = 0  # element 0's last residue, in every frame
        elif view[2] == 1:
            mask[:, L_ATLAS - ATLAS_PAD:] = 0  # the 200-residue protein's padding
        else:
            mask[0, :, -1] = 0
        kw = dict(num_heads=H, base2=False)
        got = kern(qkv, bk_c, bv, mask, **kw)
        ref = plain(qkv.float(), bk_c.float(), bv.float(), mask, **kw)
        extra = {}
        if qs != 1.0:
            extra["max_abs_err_vs_f32_twin"] = (got.float() - ref).abs().max().item()
            extra["max_logit"] = max_logit(qkv, bk_c, mask, H)
            ref = rope_attention_math(qkv.float(), bk_c.float(), bv.float(), mask, **kw,
                                      stage=bf)
        err = check(f"{kern.__name__}[{name}]", got, ref, 1e-2)
        del ref
        q, k, v, am = sdpa_inputs(qkv, bk_c, bv, mask, H)
        S_, N_ = view[0] * view[2], view[1]
        run = lambda: kern(qkv, bk_c, bv, mask, **kw)  # noqa: E731
        if kern is tiled_attention:
            extra.update(long_key_times("tiled_attention", run, S_ * H * N_ * (N_ + 1),
                                        TLA.resources(view[0], N_, view[2], H, D, base2=False)))
        else:
            extra["back_to_back_ms"] = back_to_back_ms(run)
        out[name] = dict(
            shape=f"{S_} sequences x {H} heads, {N_} queries, {N_ + 1} keys, D = {D}, natural",
            kernel=kern.__name__, max_abs_err=err[0], tol=err[1], q_scale=qs, **extra,
            ms=time_ms(run),
            plain_ms=time_ms(lambda: plain(qkv, bk_c, bv, mask, **kw), reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                       scale=1.0)),
            library_back_to_back_ms=back_to_back_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=am, scale=1.0)),
            bound=bound_ms(nbytes(qkv, bk_c, bv, mask) + qkv.numel() // 3 * 2,
                           4.0 * S_ * H * N_ * (N_ + 1) * D))
        del q, k, v, am, qkv
    # fused_attention_fwd, natural, at the no_rope views (bias key appended, no RoPE)
    for name, (S_, N_) in (("no_rope_frames", (B * L, T)), ("no_rope_residue", (B * T, L))):
        q = (torch.randn(S_, H, N_, D, generator=g, device=dev) * D ** -0.5).to(bf)
        k, v = (torch.randn(S_, H, N_ + 1, D, generator=g, device=dev).to(bf) for _ in range(2))
        kv = torch.ones(S_, N_ + 1, device=dev)
        kv[0, :N_ // 2] = 0
        got, _ = fused_attention_fwd(q, k, v, kv, base2=False)
        ref, _ = fused_attention_fwd_plain(q.float(), k.float(), v.float(), kv, base2=False)
        err = check(f"fused_attention_fwd[{name}]", got, ref, 1e-2)
        am = ((kv - 1.0) * 1e9).to(bf)[:, None, None, :]
        run = lambda: fused_attention_fwd(q, k, v, kv, base2=False)  # noqa: E731
        res_ = FA.fwd_resources(S_ * H, N_, N_ + 1, D, False)
        out[name] = dict(
            shape=f"{S_} sequences x {H} heads, {N_} queries, {N_ + 1} keys, D = {D}, natural, "
                  f"{res_['form']} form",
            kernel="fused_attention_fwd", max_abs_err=err[0], tol=err[1],
            ms=time_ms(run), back_to_back_ms=back_to_back_ms(run),
            parent=parent_times("fused_attention", run), resources=res_,
            plain_ms=time_ms(lambda: fused_attention_fwd_plain(q, k, v, kv, base2=False), reps=5),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                       scale=1.0)),
            library_back_to_back_ms=back_to_back_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=am, scale=1.0)),
            # q, k, v, the mask, o and the statistic, each once
            bound=bound_ms(nbytes(q, k, v, kv) + q.numel() * 2 + S_ * H * N_ * 4,
                           4.0 * S_ * H * N_ * (N_ + 1) * D))
    # blocked_attention_bwd beyond fp16's range (RoPE'd q ~ 2e5, k ~ 1e-5)
    arows, aframes = (B_ATLAS * T_ATLAS, L_ATLAS, 1), (B_ATLAS, T_ATLAS, L_ATLAS)
    amask = torch.ones(aframes, device=dev)
    amask[:, :, L_ATLAS - ATLAS_PAD:] = 0
    bkf = (torch.randn(C, generator=g, device=dev) * 1e-5).to(bf)
    for name, view in (("blocked_fp16_range_rows_N256", arows),
                       ("blocked_fp16_range_frames_N250", aframes)):
        qkv = qkv_case(view, 2e5 * D ** 0.5, 1e-5 * D ** -0.5)
        do = torch.randn(*view, C, generator=g, device=dev).to(bf)
        mk = amask.view(view)
        got = BA.blocked_attention_bwd(qkv, do, bkf, bv, mk, num_heads=H)
        ref = BA.blocked_attention_bwd_plain(qkv.float(), do.float(), bkf.float(), bv.float(), mk,
                                             num_heads=H)
        errs = [check(f"blocked_attention_bwd[{name}].{n}", a, b, 1e-2)
                for n, a, b in zip(("dqkv", "dbk", "dbv"), got, ref)]
        own = {}
        for j, part in enumerate(("dq", "dk", "dv")):
            a, b = got[0][..., j * C:(j + 1) * C].float(), ref[0][..., j * C:(j + 1) * C]
            scale = b.abs().max().item()
            own[part] = [(a - b).abs().max().item() / scale, 1e-2]
            if not own[part][0] <= 1e-2:
                raise AssertionError(f"blocked_attention_bwd[{name}].{part}: {own[part]} of its "
                                     f"own scale {scale}")
        del ref
        S_, N_ = view[0] * view[2], view[1]
        out[name] = dict(
            shape=f"{S_} sequences x {H} heads, N = {N_}, D = {D}, max |q| "
                  f"{qkv[..., :C].float().abs().max().item():.3g}, max |k| "
                  f"{qkv[..., C:2 * C].float().abs().max().item():.3g}",
            kernel="blocked_attention_bwd", max_abs_err=max(e for e, _ in errs),
            tol={n: t for n, (_, t) in zip(("dqkv", "dbk", "dbv"), errs)},
            err_of_own_scale=own,
            ms=time_ms(lambda: BA.blocked_attention_bwd(qkv, do, bkf, bv, mk, num_heads=H)),
            plain_ms=None, library_ms=None,
            bound=bound_ms(nbytes(qkv, do, mk, bkf, bv) + qkv.numel() * 2,
                           10.0 * S_ * H * N_ * (N_ + 1) * D))
        del qkv, do
    # row 11c (the short-route frame block, a + b + a at base 2) as a whole at
    # the flagship shape, under the composition rule
    from mdgen_finetune_tpu_torch.ops import time_attention as TA

    M = B * T * L
    x = torch.randn(M, C, generator=g, device=dev).to(bf)
    mods = [(torch.randn(B, C, generator=g, device=dev) * 0.3).to(bf) for _ in range(3)]
    ws = [(torch.randn(*s_, generator=g, device=dev) * sc_).to(bf) for s_, sc_ in
          (((C, 3 * C), C ** -0.5), ((3 * C,), 0.1), ((C, C), C ** -0.5), ((C,), 0.1), ((C,), 1.0),
           ((C,), 1.0))]
    mask = torch.ones(B, T, L, device=dev)
    mask[0, :, -1] = 0
    dims = dict(B=B, T=T, L=L, num_heads=H)
    errs = held_composite("time_attention_block[row11c]",
                          lambda *a, **k: (TA.time_attention_block(*a, **k),),
                          lambda *a, **k: (TA.time_attention_block_plain(*a, **k),),
                          [x, *mods, *ws, mask], dims, ["out"])
    out["row11c_block"] = dict(
        shape=f"time_attention_block, short route: B = {B}, T = {T}, L = {L}, {M} rows",
        kernel="time_attention_block (adaln_linear + rope_attention + adaln_linear)",
        rel_l2=errs["out"][0], tol=errs["out"][1],
        ms=time_ms(lambda: TA.time_attention_block(x, *mods, *ws, mask, **dims)),
        plain_ms=time_ms(lambda: TA.time_attention_block_plain(x, *mods, *ws, mask, **dims),
                         reps=5),
        library_ms=None,
        bound=bound_ms(nbytes(x, mask, *mods, *ws) + M * C * 2,
                       2.0 * M * C * 4 * C + 4.0 * B * L * H * T * (T + 1) * D))
    emit({"phase": "modular_kernels", "kernels": out,
          "rule": "max abs err <= 0.01 x max(1, max |plain f32|); blocked_attention_bwd's dq, "
                  "dk, dv also within 0.01 of their own scale"})
    return out


def phase_modular_cuda_vs_cpu(dev):
    """One velocity evaluation (``forward_inference``) card against CPU for
    each modular config at full width with the trunk cut to 1 layer of 5
    (the CPU pays for every layer): B = 2, T = 100, and ``interleave_ipa`` at
    T = 1000 with B = 1; the card's launches of that evaluation as derived."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    res = {}
    cells = [(f, T, 2) for f in MODULAR_FLAGS] + [("interleave_ipa", T_SIM, 1)]
    for i, (flag, Tc, Bc) in enumerate(cells):
        cfg = modular_config(flag, frames=Tc, layers=1)
        eng, sd = random_engine(dev, cfg, seed=91 + i)
        cpu = InferenceEngine(cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False)),
                              sd, device="cpu")
        atom14, seqres, mask = make_inputs(Bc, 95 + i, "cpu", pad=0 if flag == "hyena" else 1)
        feats = cpu._expand_frame0(atom14, seqres, mask)
        zs = torch.randn(Bc, Tc, L, cfg.latent_dim, generator=torch.Generator().manual_seed(99))
        wrappers, _ = _counters(MODULAR_WRAPPERS)
        vel = {}
        for name, e in (("cuda", eng), ("cpu", cpu)):
            d = e.device
            kw = prep_batch(e.cfg, {k: v.to(d) for k, v in feats.items()})["model_kwargs"]
            before = {fn.__name__: fn.launches for fn in wrappers}
            v = e.model.forward_inference(zs.to(d), torch.full((Bc,), 0.4, device=d), kw["mask"],
                                          start_frames=kw["start_frames"], x_cond=kw["x_cond"],
                                          x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
            if name == "cuda":
                torch.cuda.synchronize()
                per_eval = {fn.__name__: fn.launches - before[fn.__name__] for fn in wrappers}
            vel[name] = v.float().cpu()
        rel = ((vel["cuda"] - vel["cpu"]).norm() / vel["cpu"].norm()).item()
        want, _ = modular_launches_per_eval(cfg)
        key = f"{flag}_T{Tc}_B{Bc}"
        res[key] = dict(rel_l2=rel, velocity_norm_cpu=vel["cpu"].norm().item(),
                        launches_per_eval=per_eval)
        if not rel <= 5e-2 or not torch.isfinite(vel["cuda"]).all():
            raise AssertionError(f"modular_cuda_vs_cpu[{key}]: relative L2 {rel} > 5e-2")
        if per_eval != want:
            raise AssertionError(f"modular_cuda_vs_cpu[{key}]: launches {per_eval}, "
                                 f"expected {want}")
        del eng, cpu
    emit({"phase": "modular_cuda_vs_cpu", "tol": 5e-2, "cells": res,
          "cut": "trunk cut to 1 layer of 5 (the CPU pays for every layer); full width"})


def phase_modular_cli(dev):
    """The forward-simulation CLI with an ``interleave_ipa`` checkpoint on
    the card: ``cli.synth_data`` writes one 1,100-frame peptide; a checkpoint
    directory in the layout ``Trainer.save_checkpoint`` writes holds the
    preset's config with ``interleave_ipa`` and seeded random weights; then
    ``cli.sim_inference`` rolls out one 1,000-frame window with the preset's
    dopri5, and the PDB parses back to 1,000 models of 4 residues with
    ideal backbone bonds."""
    import numpy as np

    from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data
    from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models, from_pdb_string
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    data, out, ckpt = SCRATCH / "modular_data", SCRATCH / "modular_out", SCRATCH / "modular_ckpt"
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "--num_frames", "1100",
                     "--suffix", "_i100"])
    cfg = modular_config("interleave_ipa", frames=T_SIM, method="dopri5")
    sd = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(45), scale=0.05).state_dict()
    ckpt.mkdir(parents=True, exist_ok=True)
    torch.save({"step": 0, "params": sd, "opt_state": {}, "ema_params": sd}, ckpt / "state.pt")
    (ckpt / "config.json").write_text(cfg.to_json())
    t0 = time.perf_counter()
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(data),
                        "--split", str(data / "split.csv"), "--out_dir", str(out),
                        "--num_frames", str(T_SIM), "--num_rollouts", "1", "--suffix", "_i100",
                        "--device", str(dev)])
    secs = time.perf_counter() - t0
    meta = json.loads((out / "AAGG_meta.json").read_text())
    path = out / "AAGG.pdb"
    models = from_pdb_models(str(path))
    pos = np.stack([from_pdb_string(c).atom_positions
                    for c in path.read_text().split("ENDMDL") if "ATOM" in c])
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    dev_nca, dev_cac = float(np.abs(n_ca - 1.458).max()), float(np.abs(ca_c - 1.522).max())
    residues = sorted({len(a) for a, _ in models})
    emit({"phase": "modular_cli", "flag": "interleave_ipa", "meta": meta, "cli_s": secs,
          "models": len(models), "residues_per_model": residues,
          "pdb_bytes": path.stat().st_size, "n_ca_max_dev": dev_nca, "ca_c_max_dev": dev_cac})
    for d in (data, out, ckpt):
        shutil.rmtree(d, ignore_errors=True)
    if len(models) != T_SIM or residues != [L] or meta["frames"] != T_SIM:
        raise AssertionError(f"modular_cli: {len(models)} models of {residues} residues")
    if not np.isfinite(pos).all() or dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"modular_cli: backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")


# the modular layer's training path: the kernel wrappers, as (module, wrapper)
MODULAR_TRAIN_PAIRS = tuple((n, n) for n in TRAIN_WRAPPERS) + (
    ("fused_attention", "fused_attention_fwd"), ("fused_attention", "fused_attention_bwd"))
MODULAR_TRAIN_FLAGS = {"hyena": {"hyena": True}, "no_rope": {"no_rope": True},
                       "interleave_ipa": {"interleave_ipa": True}, "dropout": {"dropout": 0.1}}


def modular_train_config(flag, batch_size, layers=NL):
    """``train_config`` (the ``train_path`` config: 5 x 384, 16 heads,
    prepend-IPA 4 x 32, T = 100, L = 4, bf16) with one of
    ``MODULAR_TRAIN_FLAGS``, on the synthetic ``modular_data``."""
    cfg = train_config(batch_size)
    return cfg.replace(model=dataclasses.replace(cfg.model, num_layers=layers,
                                                 **MODULAR_TRAIN_FLAGS[flag]),
                       data=dataclasses.replace(cfg.data, data_dir=str(SCRATCH / "modular_data")))


def modular_train_launches_derived(flag, layers=NL):
    """The kernel launches of one ``Trainer.train_step`` (forward and
    backward) of ``modular_train_config(flag)``, derived from the code.

    - The prepend encoder's forward (``_EncoderFn``): per layer 6
      ``adaln_linear``, 1 ``ipa_attention`` and its residue core
      (``rope_attention``'s natural short body, ``fused_attention_fwd``
      under ``no_rope``); its backward is the f32 plain recompute (no
      kernel). Under dropout the encoder takes its plain path: no kernel.
    - The head (``FinalLayerFn``): 1 ``adaln_linear`` forward, its backward
      autograd through the plain math.
    - A modular stage (``adaln_stage``): forward 2 ``adaln_linear`` and its
      core; backward 1 ``adaln_linear`` (y), 4 ``linear_bwd`` (wgrad and
      dgrad of both products), 1 ``modln_bwd`` and the core's backward:
      ``rope_attention_bwd``'s natural short body (hyena's residue
      stage), ``fused_attention_bwd`` (``no_rope``), none for Hyena's FFT and
      the dropout path's dense probabilities.
    - ``adaln_mlp`` (``AdaLNMLPFn``): forward 2 ``adaln_linear``; backward
      ``adaln_mlp_bwd``, 2 ``adaln_linear``, 4 ``linear_bwd``, 1 ``modln_bwd``.
    - ``interleave_ipa``: per layer the IPA block (``IPABlockFn``: 2
      ``adaln_linear`` + 1 ``ipa_attention``, its backward the f32 plain
      recompute), then ``FusedLayerFn``: forward ``trunk_layer`` (6
      ``adaln_linear``, 2 ``rope_attention`` at base 2), backward
      ``fused_layer_bwd``'s split route (6 ``adaln_linear``, 2
      ``rope_attention`` recomputed, 12 ``linear_bwd``, 3 ``modln_bwd``, 2
      ``rope_attention_bwd`` at base 2: the short body for the residues,
      the long one for T = 100 frames).

    Returns (launches, ``rope_attention_bwd.bodies`` per step)."""
    n = {k: 0 for _, k in MODULAR_TRAIN_PAIRS}
    enc = flag != "dropout"
    n["adaln_linear"] = 6 * layers * enc + 1
    n["ipa_attention"] = layers * enc
    n["fused_attention_fwd" if flag == "no_rope" else "rope_attention"] += layers * enc
    bodies = [0, 0, 0]
    if flag == "interleave_ipa":
        n["adaln_linear"] += layers * (2 + 6 + 6)
        n["ipa_attention"] += layers
        n["rope_attention"] += layers * 4
        n["linear_bwd"] += 12 * layers
        n["modln_bwd"] += 3 * layers
        n["rope_attention_bwd"] += 2 * layers
        bodies = [layers, layers, 0]
        return n, bodies
    # two modular stages and the MLP: 6 adaln_linear forward, 4 backward
    n["adaln_linear"] += layers * 10
    n["linear_bwd"] += 12 * layers
    n["modln_bwd"] += 3 * layers
    if flag == "hyena":
        n["rope_attention"] += layers
        n["rope_attention_bwd"] += layers
        bodies = [0, 0, layers]
    elif flag == "no_rope":
        n["fused_attention_fwd"] += 2 * layers
        n["fused_attention_bwd"] += 2 * layers
    return n, bodies


def phase_modular_bwd_kernels(dev):
    """The natural-softmax mode of ``rope_attention_bwd``'s short body (row
    f' natural: the backward of TPU row 12, the modular layer's residue
    attention) against its plain twin in f32 on the card, at ``hyena``'s
    residue shape (B = 32, T = 100: 3,200 frames of L = 4, C = 384, 16
    heads) at unit logits and with q scaled 400x (logits ~1e3, the max
    subtraction's case, as ``modular_kernels`` feeds the forward), and the
    N > 16 natural route through ``fused_attention`` (row i,
    ``natural_long_bwd``) at an L = 32 residue view. ms by events, back to
    back, the host's time, the plain twin's ms, the bound (each input read
    once, each output written once; ~10 N (N + 1) D operations per sequence
    and head), and as the library time ``torch.autograd`` of SDPA's
    backward on the RoPE'd heads (its forward taken once outside the
    timing); the launch resources."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    g = torch.Generator(device=dev).manual_seed(301)
    bf = torch.bfloat16
    D = C // H
    out = {}
    for name, (G_, N_), qs in (("natural_residue_B32", (B_TRAIN * T, L), 1.0),
                               ("natural_residue_B32_q400", (B_TRAIN * T, L), 400.0),
                               ("natural_long_route_L32", (800, 32), 1.0)):
        view = (G_, N_, 1)
        qkv = torch.randn(*view, 3 * C, generator=g, device=dev)
        qkv[..., :C] *= D ** -0.5 * qs
        qkv = qkv.to(bf)
        do = (0.1 * torch.randn(*view, C, generator=g, device=dev)).to(bf)
        bk, bv = (torch.randn(C, generator=g, device=dev).to(bf) for _ in range(2))
        mask = torch.ones(view, device=dev)
        mask[:T, -1] = 0  # element 0's last residue, in every frame
        kw = dict(num_heads=H, base2=False)
        before = list(RB.rope_attention_bwd.bodies)
        got = RB.rope_attention_bwd(qkv, do, bk, bv, mask, **kw)
        ref = RB.rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                          **kw)
        torch.cuda.synchronize()
        launched = RB.rope_attention_bwd.bodies[2] - before[2]
        if launched != int(N_ <= 16):
            raise AssertionError(f"modular_bwd_kernels[{name}]: natural short launches "
                                 f"{launched}")
        errs = [check(f"rope_attention_bwd[{name}].{p}", a, b, 1e-2)
                for p, a, b in zip(("dqkv", "dbk", "dbv"), got, ref)]
        del ref
        q, k, v, am = sdpa_inputs(qkv, bk, bv, mask, H)
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=1.0)
        dob = torch.randn_like(o)
        lib = lambda: torch.autograd.grad(o, (q, k, v), dob, retain_graph=True)  # noqa: E731
        run = lambda: RB.rope_attention_bwd(qkv, do, bk, bv, mask, **kw)  # noqa: E731
        S_ = G_
        entry = dict(
            shape=f"{S_} sequences x {H} heads, {N_} queries, {N_ + 1} keys, D = {D}, natural"
                  + (", q x 400" if qs != 1.0 else ""),
            route="short body (csrc/rope_attention_bwd.cuh, NAT)" if N_ <= 16 else
                  "fused_attention_fwd + fused_attention_bwd (row i), RoPE outside",
            max_abs_err=max(e for e, _ in errs),
            tol={p: t for p, (_, t) in zip(("dqkv", "dbk", "dbv"), errs)},
            max_logit=max_logit(qkv, bk, mask, H),
            ms=time_ms(run), back_to_back_ms=back_to_back_ms(run), host_ms=host_ms(run),
            plain_ms=time_ms(lambda: RB.rope_attention_bwd_plain(qkv, do, bk, bv, mask, **kw),
                             reps=5),
            library_ms=time_ms(lib),
            library_note="torch.autograd.grad of F.scaled_dot_product_attention on the RoPE'd "
                         "heads (the backward alone; the forward outside the timing)",
            bound=bound_ms(nbytes(qkv, do, bk, bv, mask) + qkv.numel() * 2 + 2 * C * 4,
                           10.0 * S_ * H * N_ * (N_ + 1) * D))
        if N_ <= 16:
            entry["resources"] = RB.resources(N_, H, C, G_, 1, base2=False)
            entry["parent"] = None  # the natural mode is new: no earlier commit has it
        out[name] = entry
        del q, k, v, o, qkv, do
    emit({"phase": "modular_bwd_kernels", "kernels": out,
          "rule": "max abs err <= 0.01 x max(1, max |plain f32|) per output"})
    return out


def phase_train_modular(dev):
    """The modular layer trained through ``Trainer`` at full width (the
    ``train_path`` config: 5 x 384, 16 heads, prepend IPA 4 x 32, T = 100,
    L = 4, bf16, B = 32) for each of ``hyena``, ``no_rope``,
    ``interleave_ipa`` and the flagship with ``dropout = 0.1``
    (``train_cell``: 2 warm-up and 10 timed steps, 20 steps on one fixed
    batch, a checkpoint round trip; the loss finite and the parameters
    moving), each with its launches per step as derived
    (``modular_train_launches_derived``) and asserted, ``rope_attention_bwd``
    by body, no plain twin on the card, and a trace of one step (idle
    share). Returns ({flag: launches per step, with the natural short
    body's as ``rope_attention_bwd.natural``}, {flag: the natural short
    body's launches over the cell's run})."""
    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    split = make_synthetic_dataset(str(SCRATCH / "modular_data"), ["AAGG", "GHKL"],
                                   num_frames=300)
    res, natural = {}, {}
    for flag in MODULAR_TRAIN_FLAGS:
        cfg = modular_train_config(flag, B_TRAIN)
        want, want_bodies = modular_train_launches_derived(flag)
        RB.rope_attention_bwd.bodies = [0, 0, 0]
        products, attention = step_flops(B_TRAIN, T, L)
        launches, per_step, (trainer, state, tbatch, tgen) = train_cell(
            dev, f"train_modular_{flag}", cfg, split, B_TRAIN, MODULAR_TRAIN_PAIRS,
            3 * products + 3.5 * attention,
            {"flag": flag, "launches_per_step_derived": want,
             "rope_attention_bwd_bodies_per_step_derived": want_bodies})
        steps = 33  # train_cell: 2 + 10 + 20 + 1
        bodies = [b / steps for b in RB.rope_attention_bwd.bodies]
        natural[flag] = RB.rope_attention_bwd.bodies[2]
        moved = sum((state.params[k] - state.ema_params[k]).abs().max().item() > 0
                    for k in state.params)
        emit({"phase": f"train_modular_{flag}_checks", "rope_attention_bwd_bodies_per_step":
              bodies, "params_moved_from_ema": moved, "params": len(state.params)})
        if per_step != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"train_modular_{flag}: launches per step {per_step}, "
                                 f"expected {want}")
        if bodies != [float(b) for b in want_bodies]:
            raise AssertionError(f"train_modular_{flag}: rope_attention_bwd bodies {bodies}, "
                                 f"expected {want_bodies}")
        if not moved:
            raise AssertionError(f"train_modular_{flag}: the parameters did not move")
        phase_trace(f"train_modular_{flag}_trace",
                    lambda: trainer.train_step(state, tbatch, tgen))
        res[flag] = {**per_step, "rope_attention_bwd.natural": bodies[2]}
        del trainer, state
    shutil.rmtree(SCRATCH / "modular_data", ignore_errors=True)
    return res, natural


def phase_hyena_likelihood(dev):
    """One log-likelihood step of the ``hyena`` config (seeded random
    weights, full width, bf16) at B = 16: ``LatentMDGen.forward`` on the
    modular branch and its VJP in x (the natural short backward of the
    residue stage, Hyena's FFT through autograd); ll finite of shape (B,);
    x0 and delta_logp with the kernels against the plain twins on the card
    in bf16 and in f32, the same probe, the repo's rule; the launches of the
    step."""
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.inference import sampling as S
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    cfg = modular_config("hyena")
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False))
    eng, sd = random_engine(dev, cfg, seed=311)
    Bl = 16
    batch, _ = make_trajectories(Bl, 312, dev)
    probes = torch.randint(0, 2, (1, Bl, T, L, cfg.latent_dim), generator=torch.Generator(
        device=dev).manual_seed(313), device=dev).float() * 2 - 1
    recorded = []
    integrate = S.ode_likelihood

    def recording(*a, **k):
        out = integrate(*a, **k)
        recorded.append(out)
        return out

    def run(e):
        def go():
            ll = e.log_likelihood(batch, num_steps=1, probes=probes)
            return ll, recorded[-1]
        return go

    S.ode_likelihood = recording
    try:
        run(eng)()  # warm-up
        torch.cuda.synchronize()
        wrappers, twins = _counters(MODULAR_TRAIN_PAIRS)
        before = {fn.__name__: fn.launches for fn in wrappers}
        natural_before = RB.rope_attention_bwd.bodies[2]
        for fn in twins:
            fn.cuda_calls = 0
        t0 = time.perf_counter()
        ll, (x0, delta) = run(eng)()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches - before[fn.__name__] for fn in wrappers}
        # the natural short body's launches (row f' natural)
        launches["rope_attention_bwd.natural"] = RB.rope_attention_bwd.bodies[2] - natural_before
        twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
        _, plain = with_twins(run(eng))
        f32 = InferenceEngine(cfg32, sd, device=dev)
        _, truth = with_twins(run(f32))
        del f32
    finally:
        S.ode_likelihood = integrate
    twins_x0, ok_x0 = composition(x0, plain[0], truth[0])
    twins_dl, ok_dl = composition(delta, plain[1], truth[1])
    emit({"phase": "hyena_likelihood", "B": Bl, "T": T, "L": L, "C": C, "layers": NL,
          "dtype": "bf16", "steps": 1, "ms_per_step": secs * 1e3, "launches_per_step": launches,
          "plain_calls_on_card": twin_calls, "ll_mean": ll.mean().item(),
          "kernels_vs_twins": dict(x0=twins_x0, delta_logp=twins_dl),
          "rule": "rel(card) <= 2 rel(plain bf16) + 0.01, truth: plain f32"})
    if ll.shape != (Bl,) or not torch.isfinite(ll).all():
        raise AssertionError(f"hyena_likelihood: ll {ll}")
    if any(twin_calls.values()) or not launches["rope_attention_bwd.natural"] > 0:
        raise AssertionError(f"hyena_likelihood: twins {twin_calls}, launches {launches}")
    if not (ok_x0 and ok_dl):
        raise AssertionError(f"hyena_likelihood: over the rule: {twins_x0} {twins_dl}")
    return launches


def phase_micro_ops(dev):
    """Row 13: the micro-op probe (``mdgen_finetune_tpu_torch.tools.micro_ops``,
    ``csrc/micro_ops.cu``): every op of the JAX probe's list held against its
    plain version (K = 2, 32 programs; the plain and the position-weighted
    sums, each within ``REL`` of its terms' magnitudes), then timed at K = 2
    and 10 (CUDA events, median of 5; the launch count is these timed
    launches); prints the marginal-cost table. With MDGEN_PARENT_CSRC the
    parent's probe is timed the same way on the same inputs (``parent``: its
    table beside this one). The kernel line's times are those of
    ``dot_416x384x384`` at K = 2 (its bound: the bytes of x, the only input
    it reads, and the products' operations, the larger, over the whole card
    and over the probe's 32 SMs; plain: the same K-sums in torch)."""
    from mdgen_finetune_tpu_torch.tools import micro_ops as P

    x, y = P.inputs(dev)
    held = {n: P.check(x, y, n) for n in P.NAMES}
    P.micro_ops.launches = 0  # the probe's own run: its timed launches
    res = {}
    for n in P.NAMES:
        t2, t10, us = P.measure(x, y, n)
        res[n] = dict(t2_ms=t2, t10_ms=t10, marginal_us=us, max_abs_err=held[n][0],
                      max_rel_err=held[n][1])
    launches = P.micro_ops.launches
    parent = None
    if parent_lib("micro_ops") is not None:
        parent = {}
        with with_parent(("micro_ops",)):
            for n in P.NAMES:
                t2, t10, us = P.measure(x, y, n)
                parent[n] = dict(t2_ms=t2, t10_ms=t10, marginal_us=us)
    print("micro_ops marginal cost, us per op per program (card above)"
          + (", parent beside it:" if parent else ":"), flush=True)
    for n, r in sorted(res.items(), key=lambda kv: -kv[1]["marginal_us"]):
        print(f"  {r['marginal_us']:10.3f}" + (f"  {parent[n]['marginal_us']:10.3f}" if parent else "")
              + f"  {n}", flush=True)
    rep = "dot_416x384x384"
    # library yardstick: the same 64 products (32 programs x K = 2) of the
    # rotated x (416 x 384) and x[:384, :384], bf16, as one torch.bmm (the
    # operands stacked outside the timed call; the probe's sums not taken)
    a = torch.stack([P._rot(x[b], k) for b in range(x.shape[0]) for k in range(2)])
    wb = x[:, :384, :384].repeat_interleave(2, 0).contiguous()
    flops = 2.0 * 416 * 384 * 384 * 2 * 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = dict(shape=f"{rep}: 32 programs x K = 2 (x (32, 416, 384), y (32, 416, 1536) bf16)",
               max_abs_err=max(r["max_abs_err"] for r in res.values()),
               tol=f"{P.REL} x the sum of the terms' magnitudes, per program, for the plain "
                   f"and the position-weighted sum", ms=res[rep]["t2_ms"],
               back_to_back_ms=back_to_back_ms(lambda: P.micro_ops(x, y, rep, 2)),
               plain_ms=time_ms(lambda: P.micro_ops_plain(x, y, rep, 2), reps=3, warmup=1),
               library_ms=time_ms(lambda: torch.bmm(a, wb)),
               library_note="torch.bmm of the 64 (416 x 384) @ (384 x 384) bf16 products",
               bound=bound_ms(nbytes(x) + 32 * 2 * 4, flops),
               bound_32_sms_ms=flops / (PEAK_BF16_FLOPS * x.shape[0] / sms) * 1e3,
               parent=None if parent is None else dict(
                   ms=parent[rep]["t2_ms"], marginal_us={n: r["marginal_us"] for n, r in parent.items()}),
               launches=launches, ops=res)
    emit({"phase": "micro_ops", "ops": len(res), "launches": launches,
          "marginal_us": {n: r["marginal_us"] for n, r in res.items()},
          "parent_marginal_us": None if parent is None else {n: r["marginal_us"] for n, r in parent.items()},
          "t2_ms": {n: r["t2_ms"] for n, r in res.items()},
          "parent_t2_ms": None if parent is None else {n: r["t2_ms"] for n, r in parent.items()},
          "max_rel_err": {n: r["max_rel_err"] for n, r in res.items()}, "kernel": {
              k: v for k, v in out.items() if k not in ("ops", "parent")}})
    return out


# ---------------------------------------------------------------------------
# RTB posterior fine-tuning (``rtb/``) of the flagship prior at full width
RTB_PEPTIDES = ["AAGG", "GHKL"]
RTB_STEPS = 10  # the CLI's --sampling_length
B_RTB = 4  # the CLI's --batch_size
B_SCALE = 0.01  # the std of the adapters' seeded nonzero b


def rtb_config(steps=None):
    """The flagship config (``flagship_config``) over the RTB phases'
    synthetic split; ``steps``: the decode's Euler steps (100)."""
    cfg = flagship_config(steps=steps)
    return cfg.replace(data=dataclasses.replace(cfg.data, data_dir=str(SCRATCH / "rtb_data")),
                       workdir=str(SCRATCH / "rtb_work"))


def rtb_split():
    """Synthetic 200-frame trajectories of two peptides and their split."""
    from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset

    split = SCRATCH / "rtb_data" / "split.csv"
    if not split.exists():
        make_synthetic_dataset(str(SCRATCH / "rtb_data"), RTB_PEPTIDES, num_frames=2 * T)
    return split


def rtb_trainer(dev, batch_size, seed, cls=None, cfg=None, **kw):
    """``RTBTrainer`` (or ``cls``) at the CLI's defaults (sampling_length 10,
    traj_length 1000, rank 32, learning_cutoff 0.1, the surrogate reward)
    over the flagship prior with seeded random weights; the adapters' b
    drawn N(0, B_SCALE^2) on the CPU from ``seed`` + 1, so that the
    gradient is not the init's."""
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.rtb.priors import MDGenSimulator
    from mdgen_finetune_tpu_torch.rtb.rewards import SurrogateReward
    from mdgen_finetune_tpu_torch.rtb.trainer import RTBConfig, RTBTrainer
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    cfg = cfg or rtb_config()
    sd = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(seed), scale=0.05).state_dict()
    sim = MDGenSimulator(cfg, sd, str(rtb_split()), device=dev)
    tr = (cls or RTBTrainer)(cfg, RTBConfig(batch_size=batch_size, seed=seed), sim,
                             SurrogateReward(), workdir=str(SCRATCH / "rtb_work"), **kw)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in sorted(tr.lora):
            b = tr.lora[p]["b"]
            b.copy_(torch.randn(b.shape, generator=g) * B_SCALE)
    return tr


def rtb_launches_derived(chunks=0):
    """Launches of one RTB iteration, as derived from the code: S prior and S
    posterior evaluations, each ``LatentMDGen.forward`` (the trunk through
    ``FusedTrunkFn``: 6 products and stages 1 and 2 a layer, the head; the
    embed a plain product) with one encoder pass (``ENCODER_PER_PASS``); the
    decode of the terminal latents (the flat Euler chain of ``main_path``:
    ``STEPS`` x (6 NL + 2) products and 2 NL attention cores, the encoder
    once over the t grid); the backward of the S posterior evaluations (as
    a likelihood step's, ``LIKELIHOOD_PER_STEP``: each layer's stages
    recomputed, 12 linear_bwd, 3 modln_bwd, 2 rope_attention_bwd; the
    encoder's backward is its plain-math recompute). ``chunks``: the
    batched trainer's, whose S evaluations run without gradients and whose
    backward is one posterior evaluation and its backward per chunk."""
    S, steps = RTB_STEPS, STEPS
    ev = {"adaln_linear": 12 * NL + 1, "rope_attention": 3 * NL, "ipa_attention": NL}
    dec = {"adaln_linear": (6 * NL + 2) * steps + 6 * NL, "rope_attention": 2 * NL * steps + NL,
           "ipa_attention": NL}
    bwd = {"adaln_linear": 6 * NL, "rope_attention": 2 * NL, "linear_bwd": 12 * NL,
           "modln_bwd": 3 * NL, "rope_attention_bwd": 2 * NL}
    return {n: 2 * S * ev.get(n, 0) + dec.get(n, 0) + (chunks or S) * bwd.get(n, 0)
            + chunks * ev.get(n, 0) for n in TRAIN_WRAPPERS}


def phase_rtb_cell(dev, phase, batch_size, seed, iters=3, cls=None, chunks=0, want=None, **kw):
    """``RTBTrainer.step`` (or ``cls``'s) at full width on the surrogate
    reward: one warm-up and ``iters`` timed iterations; ms per iteration,
    the peak memory of the timed ones, the launches per iteration by kernel
    asserted equal to ``want`` (``rtb_launches_derived`` by default), the
    plain twins idle, finite losses and moved adapters. Returns (launches
    per iteration, trainer)."""
    import math

    tr = rtb_trainer(dev, batch_size, seed, cls=cls, **kw)
    tr.step(0)  # warm-up
    torch.cuda.synchronize()
    wrappers, twins = _counters()
    for fn in wrappers:
        fn.launches = 0
    for fn in twins:
        fn.cuda_calls = 0
    before = {p: ab["b"].clone() for p, ab in tr.lora.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = [tr.step(i) for i in range(1, iters + 1)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / iters
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_iter = {fn.__name__: fn.launches / iters for fn in wrappers}
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}
    want = {k: float(v) for k, v in (want or rtb_launches_derived(chunks)).items()}
    moved = sum(not torch.equal(tr.lora[p]["b"], b) for p, b in before.items())
    emit({"phase": phase, "trainer": type(tr).__name__, "policy": type(tr.model).__name__,
          "policy_parameters": sum(p.numel() for p in tr.model.parameters()),
          "B": batch_size, "T": T, "L": L, "C": C,
          **({"dtype": str(next(tr.model.parameters()).dtype).removeprefix("torch.")}
             if tr.outsourced else {"layers": NL, "dtype": "bf16"}),
          "sampling_length": RTB_STEPS,
          "traj_length": tr.rtb.num_train_timesteps, "lora_rank": tr.rtb.lora_rank,
          "adapters": len(tr.lora), "decode_steps": STEPS, "iterations": iters,
          "ms_per_iteration": secs * 1e3, "peak_memory_gb": peak_gb,
          "launches_per_iteration": per_iter, "launches_per_iteration_derived": want,
          "plain_calls_on_card": twin_calls, "history": hist, "adapters_moved": moved,
          **({"replay_chunk": tr.replay_chunk} if chunks else {})})
    if not all(math.isfinite(h[k]) for h in hist for k in ("loss", "logr", "logZ")):
        raise AssertionError(f"{phase}: non-finite metrics {hist}")
    if per_iter != want:
        raise AssertionError(f"{phase}: launches per iteration {per_iter}, expected {want}")
    if any(twin_calls.values()):
        raise AssertionError(f"{phase}: plain twins ran on the card: {twin_calls}")
    if not moved:
        raise AssertionError(f"{phase}: no adapter moved")
    return per_iter, tr


def phase_rtb_checks(dev, tr):
    """On ``rtb_main``'s trainer (B = 4, nonzero b): one posterior
    evaluation with the kernels against the same with every wrapper swapped
    for its plain twin (rel L2 <= 0.05, as ``design_main``); and with b set
    to 0 (the init's) the posterior's forward log-probs equal the prior's
    bit for bit over a whole trajectory on the card, the posterior run as
    training runs it: under grad, its merged weights and trunk pack built
    under grad, through ``FusedTrunkFn``."""
    cond, batch = tr.prior_sim.get_cond_args()
    Bn = tr.rtb.batch_size
    cond = tr._replicate(cond, Bn)
    x = torch.randn(Bn, T, L, 21, generator=torch.Generator().manual_seed(31)).to(dev)
    with torch.no_grad():
        ctx = tr.posterior_context()
        card = tr.posterior_fn(ctx, x, 500, cond)
        plain = with_twins(lambda: tr.posterior_fn(ctx, x, 500, cond))
    err = rel_l2(card.float(), plain.float())
    draws = tr.sampler.draws(torch.Generator(device=dev).manual_seed(32), Bn)
    kept = {p: ab["b"].clone() for p, ab in tr.lora.items()}
    with torch.no_grad():
        for ab in tr.lora.values():
            ab["b"].zero_()
    res = tr.sampler.sample_fwd(None, tr.posterior_context(), cond, Bn, **draws)
    with torch.no_grad():
        for p, b in kept.items():
            tr.lora[p]["b"].copy_(b)
    if not res["logpf_posterior"].requires_grad:
        raise AssertionError("rtb_checks: the b = 0 posterior ran without gradients")
    same = torch.equal(res["logpf_posterior"], res["logpf_prior"])
    emit({"phase": "rtb_checks", "B": Bn, "posterior_eval_kernels_vs_twins_rel_l2": err,
          "tol": 0.05, "b0_logpf_posterior_equals_prior": same,
          "b0_logpf": res["logpf_prior"].tolist()})
    if not err <= 0.05:
        raise AssertionError(f"rtb_checks: kernels vs twins rel L2 {err}")
    if not same:
        raise AssertionError("rtb_checks: at b = 0 logpf_posterior != logpf_prior: "
                             f"{res['logpf_posterior'].tolist()} {res['logpf_prior'].tolist()}")


def phase_grad_rtb(dev, seed=201, Bg=2, phase="grad_rtb_cuda_vs_cpu", **kw):
    """The RTB loss, pf_divergence and every adapter's (and logZ's)
    gradient of one iteration at full width on the card (bf16 kernels)
    against the CPU in f32 (the truth), held under the repo's rule
    (``phase_grad_across_devices``: each tensor's relative L2 at most twice
    that of the plain twins in bf16 on the CPU, plus 0.01; norms floored at
    1e-3 of the largest gradient's; the scalars the same with their absolute
    values). The same featurized batch (made on the CPU), x_start, step
    noise and detach flags everywhere; nonzero b. The trunk and the
    encoder are cut to 2 layers of 5 and the decode to 10 Euler steps of
    100 (the CPU pays for each; full width). The all-twin card's run
    beside. ``kw``: the trainer's other arguments (an outsourced
    ``policy=`` and its ``lora_targets=``)."""
    cfg = rtb_config(steps=10)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_layers=2))
    f32 = cfg.replace(model=dataclasses.replace(cfg.model, use_bf16=False))
    host = rtb_trainer("cpu", Bg, seed, cfg=f32, **kw)
    batch = host.prior_sim.get_batch()
    draws = host.sampler.draws(torch.Generator().manual_seed(seed + 2), Bg, detach_freq=0.2)
    host_model = host.model
    del host

    def run(d, c):
        tr = rtb_trainer(d, Bg, seed, cfg=c, **kw)
        b = {k: (v.to(d) if torch.is_tensor(v) else v) for k, v in batch.items()}
        cond, _ = tr.prior_sim.get_cond_args(b)
        cond = tr._replicate(cond, Bg)
        rep = tr._replicate({k: v for k, v in b.items() if k != "name"}, Bg)
        dr = {k: (v.to(d) if torch.is_tensor(v) else v) for k, v in draws.items()}
        res = tr.sampler.sample_fwd(None, tr.posterior_context(), cond, Bg, **dr)
        logr = tr._decode_reward(rep, res["x"])
        loss, aux = tr.objective(res, logr)
        loss.backward()
        grads = {k: p.grad.float().cpu() for k, p in tr._trainables().items()}
        return (loss.item(), float(aux["pf_divergence"]), logr.cpu().tolist()), grads

    res, secs = {}, {}
    for name, d, c, twins in (("cuda", dev, cfg, False), ("cpu_f32", "cpu", f32, False),
                              ("cpu_bf16", "cpu", cfg, False), ("cuda_plain", dev, cfg, True)):
        t0 = time.perf_counter()
        res[name] = with_twins(lambda: run(d, c)) if twins else run(d, c)
        secs[name] = time.perf_counter() - t0
    (lt, pt, _), gt = res["cpu_f32"]
    floor = 1e-3 * max(v.norm().item() for v in gt.values())

    def rel(g):
        return {k: ((g[k] - v).norm() / max(v.norm().item(), floor)).item() for k, v in gt.items()}

    def srel(a, b):
        return abs(a - b) / abs(b)

    ref = rel(res["cpu_bf16"][1])
    rule = {k: 2 * ref[k] + 0.01 for k in ref}
    (lb, pb, _), _ = res["cpu_bf16"]

    def summary(name):
        (l_, p_, logr), g = res[name]
        err = rel(g)
        worst = sorted(err, key=lambda k: err[k] - 2 * ref[k])[-5:]
        return {"loss": l_, "loss_rel": srel(l_, lt), "loss_limit": 2 * srel(lb, lt) + 0.01,
                "pf_divergence": p_, "pf_divergence_rel": srel(p_, pt),
                "pf_divergence_limit": 2 * srel(pb, pt) + 0.01, "logr": logr,
                "worst_rel_l2": max(err.values()),
                "median_rel_l2": sorted(err.values())[len(err) // 2],
                "over": [k for k in err if not err[k] <= rule[k]],
                "worst_of_rule": max(err[k] / rule[k] for k in err),
                "worst_vs_rule": {k: [err[k], rule[k]] for k in worst}}

    card = summary("cuda")
    emit({"phase": phase, "policy": type(kw.get("policy") or host_model).__name__,
          "batch": Bg, "T": T, "L": L, "layers": 2,
          "seed": seed, "sampling_length": RTB_STEPS, "decode_steps": 10,
          "cut": "the trunk and the encoder cut to 2 layers of 5, the decode to 10 Euler "
                 "steps of 100 (the CPU pays for each); full width",
          "detach_flags": [bool(f) for f in draws["detach_flags"]], "seconds": secs,
          "loss_cpu_f32": lt, "pf_divergence_cpu_f32": pt, "loss_cpu_bf16": lb,
          "pf_divergence_cpu_bf16": pb, "tensors": len(gt),
          "rule": "rel(card) <= 2 * rel(cpu bf16) + 0.01 per tensor and scalar",
          **card, "twins": {"plain": summary("cuda_plain")}})
    if card["over"] or not card["loss_rel"] <= card["loss_limit"] or \
            not card["pf_divergence_rel"] <= card["pf_divergence_limit"]:
        raise AssertionError(f"{phase}: over the rule: {card}")


def phase_rtb_cli(dev):
    """The RTB CLIs on the card over the synthetic split from a ``Trainer``
    checkpoint of the flagship config (seeded random weights):
    ``train_posterior --reward surrogate`` for 3 iterations (at the first,
    b = 0: pf_divergence exactly 0),
    ``train_conditional_posterior`` over the split's 2 peptides (B = 4, 2
    per batch, VarGrad) for 2 and ``train_prior`` (``DiffuserTrainer``) for
    4 steps; their logs finite, the checkpoints written."""
    import io
    import math

    from mdgen_finetune_tpu_torch.cli import (train_conditional_posterior, train_posterior,
                                              train_prior)
    from mdgen_finetune_tpu_torch.training import Trainer
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    split = rtb_split()
    ckpt, work = SCRATCH / "rtb_ckpt", SCRATCH / "rtb_cli"
    trainer = Trainer(flagship_config(), device=dev)
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(211), scale=0.05)
    trainer.save_checkpoint(state, str(ckpt))
    del trainer, state
    common = ["--sim_ckpt", str(ckpt), "--data_dir", str(split.parent), "--split", str(split),
              "--workdir", str(work), "--print_freq", "1"]
    secs, out = {}, {}
    for name, fn, args in (
            ("train_posterior", train_posterior.main,
             ["--reward", "surrogate", "--n_iterations", "3", "--exp_name", "post"]),
            ("train_conditional_posterior", train_conditional_posterior.main,
             ["--reward", "surrogate", "--n_iterations", "2", "--exp_name", "cond"]),
            ("train_prior", train_prior.main, ["--n_steps", "4", "--print_freq", "2"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(common + args)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        out[name] = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    post = [m for m in out["train_posterior"] if "loss" in m]
    cond = [m for m in out["train_conditional_posterior"] if "loss" in m]
    prior = out["train_prior"]
    files = {n: (work / n / f).exists() for n, f in (("post", "checkpoint.pt"),
                                                      ("cond", "checkpoint.pt"),
                                                      ("prior_distill", "prior_params.pt"))}
    emit({"phase": "rtb_cli", "cli_s": secs, "reward": out["train_posterior"][0],
          "train_posterior": post, "train_conditional_posterior": cond, "train_prior": prior,
          "files": files})
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    finite = all(math.isfinite(m[k]) for m in post + cond for k in ("loss", "logr", "logZ"))
    if len(post) != 3 or len(cond) != 2 or [m["step"] for m in prior] != [2, 4] or not finite \
            or not all(math.isfinite(m["loss"]) for m in prior) or not all(files.values()):
        raise AssertionError(f"rtb_cli: {post} {cond} {prior} {files}")
    if post[0]["pf_divergence"] != 0.0 or cond[0]["pf_divergence"] != 0.0:
        raise AssertionError(f"rtb_cli: pf_divergence at b = 0: {post[0]} {cond[0]}")
    if out["train_posterior"][0]["device"] != "cuda" or \
            out["train_conditional_posterior"][0]["device"] != "cuda":
        raise AssertionError(f"rtb_cli: not on the card: {out['train_posterior'][0]}")


# the outsourced UNet policy of RTB (``rtb/denoisers.py``)
def unet_targets(path):
    """Adapters on every Dense kernel of the UNet (never a conv's)."""
    return path.endswith("kernel")


def unet_policy(seed):
    """``UNet3DSeq`` at its class defaults (32 channels, multipliers (1, 2),
    2 ResBlocks a level, attention at rate 2, 16 channels a head) over the
    flagship latent (D = 21); every parameter seeded nonzero: N(0, 0.05^2),
    the GroupNorm weights 1 + that."""
    from mdgen_finetune_tpu_torch.rtb.denoisers import UNet3DSeq
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    unet = randomize_(UNet3DSeq(out_dim=21), torch.Generator().manual_seed(seed), scale=0.05)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.add_(1.0)
    return unet


def rtb_unet_launches_derived():
    """Launches of one RTB iteration under the UNet policy: the policy's 2 S
    evaluations and its backward are plain PyTorch ops, so only the decode
    launches kernels (``rtb_launches_derived``'s decode: the flat Euler
    chain and the encoder once over the t grid)."""
    dec = {"adaln_linear": (6 * NL + 2) * STEPS + 6 * NL,
           "rope_attention": 2 * NL * STEPS + NL, "ipa_attention": NL}
    return {n: dec.get(n, 0) for n in TRAIN_WRAPPERS}


def rtb_unet_checks(dev, tr):
    """On ``rtb_unet``'s trainer: at b = 0 the posterior's log-probs equal
    the prior's bit for bit over a whole trajectory on the card, the
    posterior under grad; the decode's kernels against their plain twins,
    as ``rtb_checks`` (rel L2 <= 0.05): one Euler step of the flat chain
    (``flat_call``) and the encoder over the decode's t grid at the
    iteration's batch, and, reported beside, one whole decode."""
    from mdgen_finetune_tpu_torch.tasks import prep_batch

    cond, batch = tr.prior_sim.get_cond_args()
    Bn = tr.rtb.batch_size
    cond = tr._replicate(cond, Bn)
    rep = tr._replicate({k: v for k, v in batch.items() if k != "name"}, Bn)
    draws = tr.sampler.draws(torch.Generator(device=dev).manual_seed(33), Bn)
    kept = {p: ab["b"].clone() for p, ab in tr.lora.items()}
    with torch.no_grad():
        for ab in tr.lora.values():
            ab["b"].zero_()
    res = tr.sampler.sample_fwd(None, tr.posterior_context(), cond, Bn, **draws)
    with torch.no_grad():
        for p, b in kept.items():
            tr.lora[p]["b"].copy_(b)
    same = torch.equal(res["logpf_posterior"], res["logpf_prior"])

    eng = tr.prior_sim.engine
    m = eng.model
    kw = prep_batch(eng.cfg, {k: v for k, v in rep.items() if torch.is_tensor(v)})["model_kwargs"]
    mask = kw["mask"].float().contiguous()
    zs0 = res["x"].detach()
    with torch.no_grad():
        pack = m.make_trunk_pack()
        consts = m.make_scan_consts(kw["x_cond"], kw["x_cond_mask"], mask, aatype=kw["aatype"])
        ts = 0.01 * torch.arange(STEPS, dtype=torch.float32, device=dev)

        def encode():
            return m.encode_steps(ts, mask, consts, pack, kw["start_frames"])

        encs, mods = encode(), m.embed_mods(m.embed_times(ts), pack)

        def step():
            return m.flat_call(zs0.clone(), mask, consts, pack, 0.01, enc=encs[0], mods=mods[0:1])

        def decode():
            return tr.prior_sim.sample(rep, zs0)[0]

        errs = {name: rel_l2(fn().float(), with_twins(fn).float())
                for name, fn in (("euler_step", step), ("encoder_grid", encode),
                                 ("whole_decode", decode))}
    emit({"phase": "rtb_unet_checks", "B": Bn, "b0_logpf_posterior_equals_prior": same,
          "b0_logpf": res["logpf_prior"].tolist(), "decode_kernels_vs_twins_rel_l2": errs,
          "tol": 0.05, "held": ["euler_step", "encoder_grid"]})
    if not res["logpf_posterior"].requires_grad:
        raise AssertionError("rtb_unet_checks: the b = 0 posterior ran without gradients")
    if not same:
        raise AssertionError("rtb_unet_checks: at b = 0 logpf_posterior != logpf_prior: "
                             f"{res['logpf_posterior'].tolist()} {res['logpf_prior'].tolist()}")
    if not (errs["euler_step"] <= 0.05 and errs["encoder_grid"] <= 0.05):
        raise AssertionError(f"rtb_unet_checks: decode kernels vs twins {errs}")


def phase_unet_distill(dev, sim, steps=20, batch_size=B_RTB):
    """``DiffuserTrainer(model=UNet3DSeq(...))`` on the card (the
    ``train_prior`` objective: the min-SNR v-prediction MSE, AdamW lr 1e-3,
    1,000 timesteps) for ``steps`` steps on U[-3, 3] latents from a fresh
    seeded init (zero heads, as the JAX package's); ms per step, and its
    loss on 8 fixed held-out draws before and after, which must fall."""
    import math

    from mdgen_finetune_tpu_torch.inference import sample_prior_latent
    from mdgen_finetune_tpu_torch.rtb.denoisers import UNet3DSeq
    from mdgen_finetune_tpu_torch.rtb.trainer import DiffuserTrainer

    cond, _ = sim.get_cond_args()
    cond = {k: v.repeat_interleave(batch_size // v.shape[0], 0) for k, v in cond.items()
            if torch.is_tensor(v)}

    def source(g):
        return sample_prior_latent(g, batch_size, T, L, 21, uniform=True)

    def held_out():
        g = torch.Generator(device=dev).manual_seed(99)
        with torch.no_grad():
            return sum(float(dt.loss(g, source(g))) for _ in range(8)) / 8

    torch.manual_seed(252)
    dt = DiffuserTrainer(sim.cfg, source, cond, lr=1e-3, model=UNet3DSeq(out_dim=21), device=dev)
    params = dt.init_params()
    state = dt.opt.init(params)
    before = held_out()
    gen = torch.Generator(device=dev).manual_seed(253)
    dt.train(params, state, 1, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, losses = dt.train(params, state, steps, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    after = held_out()
    emit({"phase": "rtb_unet_distill", "B": batch_size, "T": T, "L": L, "steps": steps,
          "ms_per_step": ms, "losses": losses, "held_out_before": before,
          "held_out_after": after})
    if not all(math.isfinite(v) for v in losses) or not after < before:
        raise AssertionError(f"rtb_unet_distill: {losses}, held-out {before} -> {after}")


def phase_rtb_unet(dev):
    """The outsourced UNet policy (module docstring); returns its launches
    per iteration. The UNet runs in f32 with TF32 off for its convolutions
    and matmuls, as the JAX package's f32 UNet and the CPU it is held to:
    every entry point of the port (``InferenceEngine``, ``Trainer``,
    ``DiffuserTrainer``) switches TF32 off process-wide
    (``geometry.rigid.full_f32``), PyTorch's default for cuDNN being on;
    the phase asserts both flags off and changes neither."""
    marks = [("start", time.perf_counter())]
    launches, tr = phase_rtb_cell(dev, "rtb_unet", B_RTB, seed=231,
                                  want=rtb_unet_launches_derived(),
                                  policy=unet_policy(232), lora_targets=unet_targets)
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}
    marks.append(("rtb_unet", time.perf_counter()))
    phase_trace("rtb_unet_trace", lambda: tr.step(9))
    marks.append(("rtb_unet_trace", time.perf_counter()))
    rtb_unet_checks(dev, tr)
    marks.append(("rtb_unet_checks", time.perf_counter()))
    phase_unet_distill(dev, tr.prior_sim)
    marks.append(("rtb_unet_distill", time.perf_counter()))
    del tr
    phase_grad_rtb(dev, seed=241, phase="grad_rtb_unet_cuda_vs_cpu",
                   policy=unet_policy(242), lora_targets=unet_targets)
    marks.append(("grad_rtb_unet_cuda_vs_cpu", time.perf_counter()))
    emit({"phase": "rtb_unet_s", "seconds": marks[-1][1] - marks[0][1],
          "by_phase_s": {n: t - marks[i][1] for i, (n, t) in enumerate(marks[1:])},
          "policy_precision": "f32, TF32 off (geometry.rigid.full_f32)", "allow_tf32": tf32})
    if any(tf32.values()):
        raise AssertionError(f"rtb_unet: TF32 on under the UNet policy: {tf32}")
    return launches


def phase_rtb(dev):
    """The RTB phases (module docstring); returns rtb_main's and rtb_unet's
    launches per iteration."""
    from mdgen_finetune_tpu_torch.rtb.trainer import RTBBatchedTrainer

    launches, tr = phase_rtb_cell(dev, "rtb_main", B_RTB, seed=221)
    phase_trace("rtb_trace", lambda: tr.step(9))
    phase_rtb_checks(dev, tr)
    del tr
    _, tr = phase_rtb_cell(dev, "rtb_main_b32", B_TRAIN, seed=222, iters=2)
    del tr
    _, tr = phase_rtb_cell(dev, "rtb_batched", B_TRAIN, seed=223, iters=2,
                           cls=RTBBatchedTrainer, chunks=-(-RTB_STEPS // 4), replay_chunk=4)
    del tr
    phase_grad_rtb(dev)
    phase_rtb_cli(dev)
    unet_launches = phase_rtb_unet(dev)
    shutil.rmtree(SCRATCH / "rtb_data", ignore_errors=True)
    shutil.rmtree(SCRATCH / "rtb_work", ignore_errors=True)
    return launches, unet_launches


KERNEL_OF = (("tiled_attention", "tiled_attention"),
             ("fused_attention_long", "fused_attention_fwd"),
             ("fused_attention_short", "fused_attention_fwd"),
             ("fused_attention_d", "fused_attention_bwd"),
             ("gemm_kernel", "adaln_linear"), ("tiled64_kernel", "adaln_linear"),
             ("rope_attention_bwd", "rope_attention_bwd"),
             ("blocked_attention_bwd", "blocked_attention_bwd"),
             ("rope_attention", "rope_attention"), ("ipa_attention", "ipa_attention"),
             ("dgrad_kernel", "linear_bwd"), ("wgrad_kernel", "linear_bwd"),
             ("row_stats_kernel", "linear_bwd"), ("modln_bwd", "modln_bwd"),
             ("colsum_kernel", "colsum (linear_bwd, modln_bwd, the attention backwards)"),
             ("fused_layer_bwd_kernel", "fused_layer_bwd_merged"))


# ---------------------------------------------------------------------------
# data and sequence parallelism (parallel/): ranks sharing this one card

PARALLEL_SEED = 31
ALL_TWINS = TRAIN_WRAPPERS + ("tiled_attention", "blocked_attention_bwd")


def mesh_config(cfg, dp, sp):
    return cfg.replace(train=dataclasses.replace(cfg.train, dp_size=dp, sp_size=sp))


def parallel_inputs(cfg, seed, pad):
    """Seeded random weights of ``cfg``'s model (``randomize_``) and a batch
    of its shape (``make_inputs`` moved by seeded noise in every frame), on
    the host."""
    from mdgen_finetune_tpu_torch.training import Trainer
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    Bn, Tn, Ln = cfg.train.batch_size, cfg.data.num_frames, cfg.data.crop
    tr = Trainer(mesh_config(cfg, 1, 1), device="cpu")
    tr.init_state(0)
    randomize_(tr.model, torch.Generator().manual_seed(seed), scale=0.05)
    weights = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    atom14, seqres, mask = make_inputs(Bn, seed, "cpu", length=Ln, pad=pad)
    atom14 = atom14[:, None] + 0.3 * torch.randn(Bn, Tn, Ln, 14, 3,
                                                 generator=torch.Generator().manual_seed(seed + 1))
    if Ln > L:  # a protein shorter than the crop: its padding is zeros
        atom14 = atom14 * mask[:, None, :, None, None]
    return weights, {"atom14": atom14, "seqres": seqres, "mask": mask}


def grad_rule(run, truth, yard):
    """The composition rule of ``phase_grad_across_devices`` for a step's
    loss and every gradient: relative L2 against the f32 truth at most
    2 x the plain bf16 twins' + 0.01 (a tensor's norm taken as at least 1e-3
    of the largest). Returns (summary, the entries over it)."""
    gt = truth["grads"]
    floor = 1e-3 * max(v.norm().item() for v in gt.values())

    def rel(g):
        return {k: ((g[k] - v).norm() / max(v.norm().item(), floor)).item()
                for k, v in gt.items()}

    e, y = rel(run["grads"]), rel(yard["grads"])
    rule = {k: 2 * y[k] + 0.01 for k in y}
    over = {k: (e[k], rule[k]) for k in e if not e[k] <= rule[k]}
    lt = truth["metrics"]["loss"]
    le = abs(run["metrics"]["loss"] - lt) / abs(lt)
    ly = abs(yard["metrics"]["loss"] - lt) / abs(lt)
    if not le <= 2 * ly + 0.01:
        over["loss"] = (le, 2 * ly + 0.01)
    return ({"loss_rel": le, "loss_rule": 2 * ly + 0.01, "worst_rel_l2": max(e.values()),
             "worst_of_rule": max(e[k] / rule[k] for k in e), "over": len(over)}, over)


def parallel_nccl_check(dev):
    """A one-rank NCCL group on this card: the collective wrapper's four
    ops on card tensors, each result checked (a one-rank reduce, gather,
    broadcast and all-to-all give their input back)."""
    import torch.distributed as dist

    from mdgen_finetune_tpu_torch.parallel import comm, launch

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{launch.free_port()}",
                            world_size=1, rank=0)
    try:
        comm.reset()
        g = dist.group.WORLD
        a = torch.arange(8.0, device=dev)
        got = {"all_reduce": comm.all_reduce(a.clone(), g),
               "all_gather": comm.all_gather(a, g),
               "broadcast": comm.broadcast(a.clone(), 0, g),
               "all_to_all": comm.all_to_all(a.view(1, 8), g).view(8)}
        torch.cuda.synchronize()
        bad = [k for k, v in got.items() if not (v.is_cuda and torch.equal(v, a))]
        counts = dict(comm.COUNTS)
    finally:
        dist.destroy_process_group()
    if bad or min(counts.values()) != 1:
        raise AssertionError(f"parallel: the one-rank NCCL group's {bad} wrong ({counts})")
    return {"backend": "nccl", "world": 1, "calls": counts}


def phase_parallel(dev):
    """Data and sequence parallelism (``parallel/``) on this one card: ranks
    spawned by ``parallel.launch.run`` share it over gloo (NCCL refuses two
    ranks on one device), so this checks the sharded paths, not their
    scaling. Each sharded run is held to this process's run on the card
    with the same weights, batch and generator:

    - the flagship trained at B = 32 (``train_config``) on meshes 2 x 1 and
      2 x 2 (the batch fold: 16 and 8 elements a rank): rank 0's loss and
      every gradient under the composition rule (``grad_rule``: the f32
      truth and the bf16 yardstick are this process's all-twin runs), the
      parameters bit-equal across the ranks after 2 steps, each rank's
      launches those of the one-process step (no count of this path depends
      on the batch), one all-reduce a step and no other collective;
    - ATLAS (``atlas_config``: crop 256, B = 1, T = 250) on 1 x 2 (the
      sequence split: 125 frames, then 128 residues a rank): one velocity
      evaluation within the kernels' rule (1e-2 x max(1, |ref|)) of the
      one-process card forward; a 10-step Euler sample (the flat chain, its
      trunk split), finite, its backbone bonds within 1e-2 A; one training
      step under the composition rule; rows 7 / g (``tiled_attention``) and
      8 / j (``blocked_attention_bwd``) launched on each rank as in the
      one-process step (``phase_train_atlas``'s counts);
    - a one-rank NCCL group running the collective wrapper's four ops on
      card tensors (``parallel_nccl_check``).

    Printed: ms a step of each layout (3 timed steps; ATLAS 2), the
    collectives' ms at the path's sizes (``checks.collective_ms``), peak
    memory a rank, the backend, the card. Returns each kernel's launches a
    rank under the fold (2 x 2) and the sequence split (ATLAS)."""
    from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch
    from mdgen_finetune_tpu_torch.parallel import checks, launch

    t_phase = time.perf_counter()
    nccl = parallel_nccl_check(dev)
    fcfg, acfg = train_config(B_TRAIN), atlas_config("euler", 10)
    fw, fbatch = parallel_inputs(fcfg, PARALLEL_SEED, pad=1)
    aw, abatch = parallel_inputs(acfg, PARALLEL_SEED + 10, pad=ATLAS_PAD)
    afeats = featurize_atom14_batch(abatch["atom14"], abatch["seqres"], abatch["mask"])
    afeats["seqres"] = afeats["seqres"].long()
    g = torch.Generator().manual_seed(PARALLEL_SEED + 20)
    velocity = (torch.randn(1, T_ATLAS, L_ATLAS, acfg.latent_dim, generator=g),
                torch.full((1,), 0.5))
    fpairs = tuple((n, n) for n in TRAIN_WRAPPERS)

    def one(cfg, w, b, names=None, f32=False, **kw):
        c = mesh_config(cfg, 1, 1)
        if f32:
            c = c.replace(model=dataclasses.replace(c.model, use_bf16=False))

        def run():
            return checks.train_steps(c, w, b, PARALLEL_SEED, device=dev, **kw)
        return with_twins(run, names) if names else run()

    ref = {"flagship": (one(fcfg, fw, fbatch, wrappers=fpairs, timed=3),
                        one(fcfg, fw, fbatch, ALL_TWINS, f32=True, steps=1),
                        one(fcfg, fw, fbatch, ALL_TWINS, steps=1)),
           "atlas": (one(acfg, aw, abatch, wrappers=ATLAS_WRAPPERS, timed=2),
                     one(acfg, aw, abatch, ALL_TWINS, f32=True, steps=1),
                     one(acfg, aw, abatch, ALL_TWINS, steps=1))}
    a_sample = checks.sample(mesh_config(acfg, 1, 1), aw, afeats, PARALLEL_SEED, device=dev,
                             wrappers=ATLAS_WRAPPERS, velocity=velocity)
    torch.cuda.empty_cache()
    n_params = sum(v.numel() for v in fw.values())
    swap = B_ATLAS * T_ATLAS * L_ATLAS * C // 2  # one rank's half of an ATLAS activation
    numels = {"all_reduce": n_params, "broadcast": n_params, "all_to_all": swap,
              "all_gather": swap}
    kw = dict(seed=PARALLEL_SEED, device=dev.type)
    t0 = time.perf_counter()
    r2 = launch.run(checks.run_jobs, 2, [
        ("train_steps", dict(cfg=mesh_config(fcfg, 2, 1), weights=fw, batch=fbatch,
                             wrappers=fpairs, timed=3, **kw)),
        ("train_steps", dict(cfg=mesh_config(acfg, 1, 2), weights=aw, batch=abatch,
                             wrappers=ATLAS_WRAPPERS, timed=2, **kw)),
        ("sample", dict(cfg=mesh_config(acfg, 1, 2), weights=aw, batch=afeats,
                        wrappers=ATLAS_WRAPPERS, velocity=velocity, **kw)),
        ("collective_ms", dict(device=dev.type, numels=numels))])
    secs2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r4 = launch.run(checks.run_jobs, 4, [
        ("train_steps", dict(cfg=mesh_config(fcfg, 2, 2), weights=fw, batch=fbatch,
                             wrappers=fpairs, timed=3, **kw)),
        ("collective_ms", dict(device=dev.type, numels=numels))])
    secs4 = time.perf_counter() - t0

    failures, layouts = [], {}

    def held(name, ranks, kind, axes):
        r0 = ranks[0]
        one_run, truth, yard = ref[kind]
        summary, over = grad_rule(r0, truth, yard)
        equal = all(torch.equal(r["params"][k], v) for r in ranks[1:]
                    for k, v in r0["params"].items())
        same_launches = all(r["launches"] == one_run["launches"] for r in ranks)
        if over:
            failures.append(f"{name}: over the composition rule: {over}")
        if not equal:
            failures.append(f"{name}: parameters differ across ranks after 2 steps")
        if not same_launches:
            failures.append(f"{name}: launches a rank {[r['launches'] for r in ranks]}, "
                            f"the one-process step's {one_run['launches']}")
        if any(tuple(map(tuple, r["axes"])) != axes for r in ranks):
            failures.append(f"{name}: layout {r0['axes']}, expected {axes}")
        layouts[name] = {
            "ranks": len(ranks), "axes": r0["axes"], "rule": summary,
            "one_process_rule": grad_rule(one_run, truth, yard)[0],
            "params_bit_equal_across_ranks": equal, "launches_per_rank": r0["launches"],
            "launches_as_one_process": same_launches, "collectives_per_step": r0["counts"],
            "collective_mb_per_step": {k: v / 1e6 for k, v in r0["bytes"].items()},
            "ms_per_step": [r["ms_per_step"] for r in ranks],
            "one_process_ms_per_step": one_run["ms_per_step"],
            "peak_memory_gb": [r.get("peak_memory_gb") for r in ranks]}
        return r0

    fold = {}
    for name, ranks in (("flagship_2x1", [r[0] for r in r2]), ("flagship_2x2", [r[0] for r in r4])):
        fold[name] = held(name, ranks, "flagship", (("dp", "sp"), ()))
        c = fold[name]["counts"]
        if c["all_reduce"] != 1 or c["all_to_all"] or c["all_gather"] or c["broadcast"]:
            failures.append(f"{name}: collectives a step {c}, not one all-reduce")
    seq = held("atlas_1x2", [r[1] for r in r2], "atlas", (("dp",), ("sp",)))
    c = seq["counts"]
    if not (c["all_to_all"] > 0 and c["all_gather"] > 0 and c["all_reduce"] > 0):
        failures.append(f"atlas_1x2: collectives a step {c}")
    for row in ("tiled_attention", "blocked_attention_bwd"):
        if not seq["launches"][row] > 0:
            failures.append(f"atlas_1x2: {row} not launched on a rank")
    samples = [r[2] for r in r2]
    v_err, v_tol = check("parallel atlas velocity", samples[0]["velocity"],
                         a_sample["velocity"], 1e-2)
    bond = output_checks("parallel atlas sample", samples[0]["atom14"], abatch["mask"], {})
    for s_ in samples:
        if s_["launches"] != a_sample["launches"] or s_["counts"]["all_to_all"] <= 0:
            failures.append(f"atlas sample: launches {s_['launches']} (one process "
                            f"{a_sample['launches']}), collectives {s_['counts']}")
        if not torch.equal(s_["atom14"], samples[0]["atom14"]):
            failures.append("atlas sample: the ranks returned different samples")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    line = {"phase": "parallel", "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "backend": "gloo: 2 and 4 ranks share this one card (NCCL refuses two ranks on "
                       "one device); timings are not scaling figures",
            "nccl_one_rank": nccl, "layouts": layouts,
            "atlas_velocity": {"max_abs_err": v_err, "tol": v_tol,
                               "launches_per_rank": samples[0]["velocity_launches"],
                               "collectives": samples[0]["velocity_counts"]},
            "atlas_euler10": {"bonds": bond, "seconds": [s_["seconds"] for s_ in samples],
                              "one_process_seconds": a_sample["seconds"],
                              "max_abs_diff_one_process":
                                  (samples[0]["atom14"] - a_sample["atom14"]).abs().max().item(),
                              "launches_per_rank": samples[0]["launches"],
                              "collectives": samples[0]["counts"]},
            "collective_ms": {"ranks_2": r2[0][3], "ranks_4": r4[0][1], "numels": numels},
            "spawn_and_run_s": {"ranks_2": secs2, "ranks_4": secs4},
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if failures:
        raise AssertionError("parallel: " + "; ".join(failures))
    return {"fold": fold["flagship_2x2"]["launches"], "seq": seq["launches"]}


def phase_trace(name, run):
    """Where the device time of ``run()`` goes: torch.profiler over one call;
    device time by kernel and the device's idle share of the window from the
    first device activity to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        emit({"phase": name, "device_time": "not measured (the profiler recorded no device activity)"})
        return
    by_kernel, by_name = {}, {}
    for e in dev:
        us = e.time_range.elapsed_us()
        group = next((k for pat, k in KERNEL_OF if pat in e.name), "other")
        by_kernel[group] = by_kernel.get(group, 0.0) + us / 1e3
        n = by_name.setdefault(e.name[:80], [0.0, 0])
        n[0] += us / 1e3
        n[1] += 1
    busy = sum(by_kernel.values())
    window = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / 1e3
    top = sorted(([k, v[0], v[1]] for k, v in by_name.items()), key=lambda r: -r[1])[:12]
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    emit({"phase": name, "window_ms": window, "device_busy_ms": busy,
          "host_ops": sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")),
          "host_top_self_ms": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host],
          "idle_share": 1.0 - busy / window, "device_ms_by_kernel": by_kernel,
          "top_device_ms_calls": top})


GRAD_TASKS = {"design": None, "mpnn": {"mpnn": True, "design": True},
              "dynamic_mpnn": {"dynamic_mpnn": True, "design": True}, "tps": "tps"}


def grad_seeds(argv):
    """``python3 chip_smoke.py --grad-seeds TASK BATCH SEED ...``: the
    task's card-vs-CPU gradient phase (``design``, ``mpnn``,
    ``dynamic_mpnn`` or ``tps``) at batch BATCH for each seed, the card with
    the kernels beside the card with all six training wrappers swapped for
    their plain twins (``plain``) and with each alone swapped
    (``plain_<wrapper>``); one line a seed, then for each run the seeds on which it missed the rule,
    its tensors over the rule and its worst error as a share of the rule."""
    task, batch, seeds = argv[0], int(argv[1]), [int(a) for a in argv[2:]]
    from mdgen_finetune_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build_all(TRAIN_WRAPPERS)
    base = tps_config() if GRAD_TASKS[task] == "tps" else design_config(GRAD_TASKS[task])
    twins = {"plain": TRAIN_WRAPPERS, **{f"plain_{n}": (n,) for n in TRAIN_WRAPPERS}}
    lines = [phase_grad_across_devices(torch.device("cuda"), task_train_config(base, batch),
                                       f"grad_seeds_{task}", seed=s, twins=twins, hold=False,
                                       extra={"task": task, "card": smi}) for s in seeds]
    runs = {"kernels": lines}
    runs.update({k: [ln["twins"][k] for ln in lines] for k in twins})
    emit({"phase": "grad_seeds", "task": task, "batch": batch, "seeds": seeds, "card": smi,
          **{k: {"seeds_missed": [s for s, r in zip(seeds, rs) if r["over"]],
                 "tensors_over": [r["over"] for r in rs],
                 "worst_of_rule": [r["worst_of_rule"] for r in rs],
                 "median_rel_l2": [r["median_rel_l2"] for r in rs]} for k, rs in runs.items()}})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.tools import merged_phase_clock as MPC

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    start_parent_builds()
    MPC.start_clock_build()
    _cuda.start_variant("rope_attention", GENERAL)
    _cuda.start_variant("ipa_attention", IPA_GENERAL)
    build_s = _cuda.build_all()
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": {n: ptxas_report(_cuda.BUILD / f"{n}.log") for n in _cuda.KERNELS}})

    cfg = flagship_config()
    kernels = phase_kernels(dev)
    short = phase_rope_short(dev)
    kernels.update(phase_bwd_kernels(dev))
    rope_long = phase_rope_long_bodies(dev)
    phase_step_across_devices(dev, cfg)
    launches, (eng, batch, gen) = phase_main_path(dev, cfg)
    phase_trace("trace", lambda: eng.sample(batch, gen))
    phase_rows_1_2(dev, eng, batch)
    del eng
    phase_step_across_devices_1000(dev)
    sim_launches, (eng, batch, gen) = phase_sim_1000(dev)
    phase_trace("trace_1000", lambda: eng.sample(batch, gen))
    del eng
    phase_sim_cli(dev)
    # the transition-path and upsampling tasks
    t_tasks = time.perf_counter()
    eng, batch, gen = phase_tps_main(dev, launches["per_sample"])
    phase_trace("tps_trace", lambda: eng.sample(batch, gen))
    del eng
    phase_tps_cli(dev)
    phase_upsampling_cli(dev)
    phase_analysis_cli()
    t_design = time.perf_counter()
    design_launches, (eng, batch, gen) = phase_design_main(dev)
    phase_trace("design_trace", lambda: eng.sample(batch, gen))
    del eng
    phase_mpnn(dev)
    phase_design_cli(dev)
    # the reverse SDE, the likelihood, the no_offsets / no_frames ablations
    t_sde = time.perf_counter()
    sde_launches, (eng, batch, gen) = phase_sde_main(dev)
    phase_trace("sde_trace", lambda: eng.sample(batch, gen))
    del eng
    ll_per_step, (eng, batch, gen) = phase_likelihood_main(dev)
    phase_trace("likelihood_trace", lambda: eng.log_likelihood(batch, gen, num_steps=10))
    del eng
    phase_sde_cli(dev)
    phase_ablations(dev)
    # training the design, mpnn / dynamic_mpnn and TPS tasks
    t_train_tasks = time.perf_counter()
    task_launches = phase_train_tasks(dev)
    phase_frame_rows_short_t(dev)
    phase_train_design_cli(dev)
    # mpnn at the training batch. At T = 1 the rule misses on about one
    # seed in ten for any bf16 card run, the plain twins' too, at B = 2 as
    # at 32, always on an encoder weight's gradient; B = 2's seed 7 is one
    # (``--grad-seeds``, PERF.md §6). The all-twin card's run stands beside
    # each task's line.
    for name, cfg_, Bg in (("design", design_config(), 2),
                           ("mpnn", design_config({"mpnn": True, "design": True}), B_TRAIN),
                           ("tps", tps_config(), 2)):
        phase_grad_across_devices(dev, task_train_config(cfg_, Bg), f"grad_cuda_vs_cpu_{name}",
                                  extra={"task": name}, twins={"plain": TRAIN_WRAPPERS})
    shutil.rmtree(SCRATCH / "task_data", ignore_errors=True)
    t_rtb = time.perf_counter()
    # RTB posterior fine-tuning of the flagship prior
    rtb_launches, rtb_unet_launches = phase_rtb(dev)
    emit({"phase": "tasks_s", "tps_and_upsampling_s": t_design - t_tasks,
          "design_s": t_sde - t_design, "sde_likelihood_ablations_s": t_train_tasks - t_sde,
          "train_tasks_s": t_rtb - t_train_tasks, "rtb_s": time.perf_counter() - t_rtb,
          "tasks_s": time.perf_counter() - t_tasks})
    phase_grad_across_devices(dev)
    train_launches, train_ref, (trainer, state, tbatch, tgen) = phase_train_path(dev)
    phase_trace("train_trace", lambda: trainer.train_step(state, tbatch, tgen))
    del trainer, state
    # the merged layer backward (MDGEN_FUSED_BWD=merged): row 4', then the
    # same training run through it
    merged = phase_merged_bwd_kernels(dev)
    merged_launches, _, (trainer, state, tbatch, tgen) = phase_train_path(dev, "merged",
                                                                          train_ref)
    with fused_bwd_route("merged"):
        phase_trace("train_merged_trace", lambda: trainer.train_step(state, tbatch, tgen))
    del trainer, state
    phase_trunk_rows(dev)
    long_bwd, _ = phase_long_bwd_kernels(dev)
    kernels.update(long_bwd)
    launches_1000, per_step_1000, (trainer, state, tbatch, tgen) = phase_train_1000(dev)
    phase_trace("train_1000_trace", lambda: trainer.train_step(state, tbatch, tgen))
    del trainer, state
    phase_train_cli(dev)
    phase_grad_across_devices(dev, train_1000_config(1), "grad_cuda_vs_cpu_1000")
    atlas = phase_atlas_kernels(dev)
    kernels["tiled_attention"]["atlas_residue_core"] = atlas["residue_core_atlas"]
    kernels["blocked_attention_bwd"] = atlas["blocked_attention_bwd"]
    atlas_sim_launches, (eng, batch, gen) = phase_sim_atlas(dev)
    phase_trace("sim_atlas_trace", lambda: eng.sample(batch, gen))
    del eng
    atlas_launches, atlas_per_step, (trainer, state, tbatch, tgen) = phase_train_atlas(dev)
    phase_trace("train_atlas_trace", lambda: trainer.train_step(state, tbatch, tgen))
    del trainer, state
    phase_grad_across_devices(dev, atlas_config(layers=1), "grad_cuda_vs_cpu_atlas", pad=ATLAS_PAD,
                              extra={"cut": "trunk cut to 1 layer of 5 (the CPU pays for every "
                                            "layer); full width, B = 1, T = 250, L = 256"})
    phase_atlas_cli(dev)
    # the modular layer: its cores, its three configs sampled, the CLI
    modular = phase_modular_kernels(dev)
    phase_modular_cuda_vs_cpu(dev)
    interleave_launches, (eng, batch, gen) = modular_sample(
        dev, "interleave_main", modular_config("interleave_ipa"), B, seed=101)
    phase_trace("interleave_trace", lambda: eng.sample(batch, gen))
    del eng
    interleave_1000_launches, (eng, batch, gen) = modular_sample(
        dev, "interleave_1000", modular_config("interleave_ipa", frames=T_SIM), B_SIM, seed=111)
    phase_trace("interleave_1000_trace", lambda: eng.sample(batch, gen))
    del eng
    hyena_launches, _ = modular_sample(dev, "hyena_main", modular_config("hyena"), B, seed=121,
                                       pad=0)
    no_rope_launches, _ = modular_sample(dev, "no_rope_main", modular_config("no_rope"), B,
                                         seed=131)
    phase_modular_cli(dev)
    # training the modular layer: the natural backward, four trained configs,
    # their gradients card vs CPU, one hyena log-likelihood step
    t_train_modular = time.perf_counter()
    modular_bwd = phase_modular_bwd_kernels(dev)
    train_modular, train_natural = phase_train_modular(dev)
    for flag in MODULAR_TRAIN_FLAGS:
        phase_grad_across_devices(dev, modular_train_config(flag, 2, layers=1),
                                  f"grad_cuda_vs_cpu_{flag}", seed=321,
                                  extra={"flag": flag, "cut": "trunk and encoder cut to 1 layer "
                                         "of 5 (the CPU pays for every layer); full width"})
    hyena_ll = phase_hyena_likelihood(dev)
    emit({"phase": "train_modular_s", "seconds": time.perf_counter() - t_train_modular})
    probe = phase_micro_ops(dev)
    parallel = phase_parallel(dev)
    shutil.rmtree(SCRATCH, ignore_errors=True)

    bwd = "mdgen_finetune_tpu/ops/fused_layer_bwd.py:563 (_k3 :157, _k2 :323, _k1 :474)"
    meta = {
        "adaln_linear": ("mdgen_finetune_tpu_torch/csrc/adaln_linear.cu",
                         "mdgen_finetune_tpu/ops/fused_layer.py:579 + mdgen_finetune_tpu/ops/ipa_encoder.py:441"),
        "rope_attention": ("mdgen_finetune_tpu_torch/csrc/rope_attention.cu",
                           "mdgen_finetune_tpu/ops/fused_layer.py:579 + mdgen_finetune_tpu/ops/ipa_encoder.py:441"),
        "ipa_attention": ("mdgen_finetune_tpu_torch/csrc/ipa_attention.cu",
                          "mdgen_finetune_tpu/ops/ipa_encoder.py:441"),
        "linear_bwd": ("mdgen_finetune_tpu_torch/csrc/linear_bwd.cu", bwd),
        "modln_bwd": ("mdgen_finetune_tpu_torch/csrc/modln_bwd.cu", bwd),
        "rope_attention_bwd": ("mdgen_finetune_tpu_torch/csrc/rope_attention_bwd.cu",
                               "mdgen_finetune_tpu/ops/fused_layer_bwd.py:323 (_k2) + :474 (_k1)"),
        "tiled_attention": ("mdgen_finetune_tpu_torch/csrc/tiled_attention.cu",
                            "mdgen_finetune_tpu/ops/time_attention.py:504 (_block_pallas_fwd_blocked, "
                            "body _block_kernel_blocked :409)"),
        "fused_attention_fwd": ("mdgen_finetune_tpu_torch/csrc/fused_attention.cu",
                                "mdgen_finetune_tpu/ops/fused_attention.py:66 (_fwd_tpu, "
                                "pallas_call :75, body _fwd_kernel :44)"),
        "fused_attention_bwd": ("mdgen_finetune_tpu_torch/csrc/fused_attention_bwd.cu",
                                "mdgen_finetune_tpu/ops/fused_attention.py:138 (_bwd_tpu, "
                                "pallas_call :149, body _bwd_kernel :94)"),
        "blocked_attention_bwd": ("mdgen_finetune_tpu_torch/csrc/blocked_attention_bwd.cu",
                                  "mdgen_finetune_tpu/ops/blocked_block_bwd.py:53 (_bwd_kernel, "
                                  "the body of time_block_bwd :298 / pallas_call :351 and "
                                  "rows_block_bwd :380 / pallas_call :427)"),
    }
    line = []
    for name, k in kernels.items():
        src, rep = meta[name]
        # launches: the flagship sampler's main-path run for the forward
        # kernels (tiled_attention: the T = 1000 sampler's), the training
        # path's run for the backward kernels, the T = 1000 training run for
        # the fused_attention kernels and the ATLAS training run for
        # blocked_attention_bwd
        if name.startswith("fused_attention"):
            n_launch = launches_1000[name]
        elif name == "tiled_attention":
            n_launch = sim_launches[name]
        elif name == "blocked_attention_bwd":
            n_launch = atlas_launches[name]
        else:
            n_launch = launches.get(name, train_launches.get(name))
        line.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": n_launch,
                     "train_launches": train_launches.get(name, 0),
                     "sim_1000_launches": sim_launches.get(name, 0),
                     "train_1000_launches_per_step": per_step_1000.get(name, 0),
                     "sim_atlas_launches": atlas_sim_launches.get(name, 0),
                     "design_main_launches": design_launches.get(name, 0),
                     "sde_main_launches": sde_launches.get(name, 0),
                     "likelihood_launches_per_step": ll_per_step.get(name, 0),
                     "train_design_launches_per_step":
                         task_launches["train_design"].get(name, 0),
                     "train_mpnn_launches_per_step": task_launches["train_mpnn"].get(name, 0),
                     "rtb_main_launches_per_iteration": rtb_launches.get(name, 0),
                     "rtb_unet_launches_per_iteration": rtb_unet_launches.get(name, 0),
                     "train_atlas_launches_per_step": atlas_per_step.get(name, 0),
                     "max_abs_err": k["max_abs_err"], "tol": k["tol"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"],
                     "shape": k["shape"],
                     **{f: k[f] for f in ("back_to_back_ms", "library_back_to_back_ms", "resources",
                                          "bf16_staging_err_of_tol", "parent", "bare_mm_ms",
                                          "ex2_floor_ms", "ex2_per_pair", "host_ms", "form",
                                          "bits_equal_parent", "general_path", "library_note",
                                          "library_max_abs_err", "L4", "L256_w16_4_6",
                                          "uses", "splits", "frames_N250", "bounds", "plan",
                                          "shapes", "kernel_ms", "launches_per_call")
                                if f in k}})
    for entry in line:  # launches a rank under the batch fold and the sequence split
        for layout in ("fold", "seq"):
            if entry["name"] in parallel[layout]:
                entry[f"parallel_{layout}_launches_per_rank_step"] = \
                    parallel[layout][entry["name"]]
    for entry in line:  # row j beyond fp16's range (the repaired q and k scales)
        if entry["name"] == "blocked_attention_bwd":
            entry["fp16_range"] = {c: modular[c] for c in modular if c.startswith("blocked_")}
        if entry["name"] in ("rope_attention", "rope_attention_bwd"):  # the long bodies' edge cases
            part = "fwd" if entry["name"] == "rope_attention" else "bwd"
            entry["edge_cases_worst_share_of_tol"] = {
                c: v for c, v in rope_long["worst_share_of_tol"].items() if c.startswith(part)}
    # the modular layer's natural-softmax cores (TPU rows 12, 11a, 11b and the
    # no_rope route of row 10): launches over hyena_main (rope_attention's
    # natural short body: row 12, the residue stage, and the encoder's MHA,
    # 10 per evaluation) and no_rope_main. Rows 11a / 11b (natural frame
    # attention): the long body's and tiled_attention's natural launches
    # counted over interleave_main and interleave_1000 (modular_sample
    # asserts 0: interleave_ipa's frame stages are the base-2 trunk's, as
    # in JAX)
    frames_natural = {part: interleave_launches[part] + interleave_1000_launches[part]
                      for part in ("rope_attention.long_natural", "tiled_attention.natural")}
    ta = "mdgen_finetune_tpu/ops/time_attention.py"
    natural = (
        ("rope_attention[natural, row 12]", "row12_residue", "rope_attention",
         "mdgen_finetune_tpu/ops/residue_attention.py:141 (_pallas_fwd, pallas_call :183, "
         "body _kernel :65)", hyena_launches["rope_attention.bodies"][1]),
        ("rope_attention[natural, row 11a]", "row11a_frames", "rope_attention",
         f"{ta}:244 (_pallas_fwd, pallas_call :279, body _kernel :190)",
         frames_natural["rope_attention.long_natural"]),
        ("tiled_attention[natural, row 11b]", "row11b_frames_T1000", "tiled_attention",
         f"{ta}:343 (_pallas_fwd_blocked, pallas_call :385, body _kernel_blocked :303)",
         frames_natural["tiled_attention.natural"]),
        # the no_rope route by view: the residue view (the trunk's residue
        # stage and the encoder's, 2 per layer and evaluation) runs the short
        # form, the frame view (1 per layer) the long one; launches counted by form
        ("fused_attention_fwd[natural, no_rope residue view]", "no_rope_residue",
         "fused_attention_fwd", "mdgen_finetune_tpu/ops/fused_attention.py:66 (_fwd_tpu, "
         "pallas_call :75)", no_rope_launches["fused_attention_fwd.forms"][1]),
        ("fused_attention_fwd[natural, no_rope frame view]", "no_rope_frames",
         "fused_attention_fwd", "mdgen_finetune_tpu/ops/fused_attention.py:66 (_fwd_tpu, "
         "pallas_call :75)", no_rope_launches["fused_attention_fwd.forms"][0]),
    )
    # rope_attention's short body at its three uses and rope_attention_bwd's
    # at stage 1; launches by body: the main path's short base 2 (stage 1)
    # and short natural (the encoder), interleave_main's short natural (the
    # residue attention of row 12 and the encoder), train_path's short
    # backward (stage 1)
    fl = "mdgen_finetune_tpu/ops/fused_layer.py"
    uses = (
        ("rope_attention[short, stage 1 base 2]", "stage1_base2", "rope_attention",
         f"{fl}:579 (_trunk_call, pallas_call :777, body _kernel :38, softmax :223-233)",
         launches["rope_attention.bodies"][0]),
        ("rope_attention[short, row 12 natural]", "row12_natural", "rope_attention",
         "mdgen_finetune_tpu/ops/residue_attention.py:141 (_pallas_fwd, pallas_call :183)",
         hyena_launches["rope_attention.bodies"][1]),
        ("rope_attention[short, encoder MHA]", "encoder_mha", "rope_attention",
         "mdgen_finetune_tpu/ops/ipa_encoder.py:441 (_encoder_call, pallas_call :484, "
         "body _kernel :234)", launches["rope_attention.bodies"][1]),
        ("rope_attention_bwd[short, stage 1]", "bwd_stage1", "rope_attention_bwd",
         "mdgen_finetune_tpu/ops/fused_layer_bwd.py:474 (_k1)",
         train_launches["rope_attention_bwd.bodies"][0]),
    )
    for name, case, src, rep_, n_launch in uses:
        k = short[case]
        line.append({"name": name, "route": "cuda", "source": meta[src][0], "replaces": rep_,
                     "launches": n_launch, "max_abs_err": k["max_abs_err"], "tol": k["tol"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"], "shape": k["shape"],
                     **{f: k[f] for f in ("back_to_back_ms", "library_back_to_back_ms", "parent",
                                          "bits_equal_parent", "resources", "general_path",
                                          "host_ms") if f in k}})
        if case == "bwd_stage1":  # the short backward's other uses (launched inside row 4' at P11)
            line[-1]["uses"] = {c: short[c] for c in ("bwd_t1000", "bwd_merged_p11")}
    for name, case, src, rep_, n_launch in natural:
        k = modular[case]
        off_path = n_launch == 0
        line.append({"name": name, "route": "cuda", "source": meta[src][0], "replaces": rep_,
                     "launches": n_launch, "max_abs_err": k["max_abs_err"], "tol": k["tol"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"],
                     "back_to_back_ms": k.get("back_to_back_ms"),
                     "library_back_to_back_ms": k.get("library_back_to_back_ms"),
                     "shape": k["shape"],
                     **{f: k[f] for f in ("parent", "ex2_floor_ms", "resources") if f in k},
                     "more_shapes": {c: {f: v for f, v in modular[c].items() if f != "shape"}
                                     for c in modular if modular[c]["kernel"] == src.split("[")[0]
                                     and c != case},
                     **({"on_model_path": False,
                         "note": "natural frame attention has no model path: interleave_ipa's "
                                 "layers run the fused (base 2) layer after their IPA, as "
                                 "JAX's gate :270 routes them; launches counted over "
                                 "interleave_main and interleave_1000"}
                        if off_path else {})})
    # row f' in natural mode (the backward of row 12): the natural short
    # body's launches counted over the four train_modular runs (hyena's
    # alone launches it, 5 a step) and per step by flag; its N > 16 route
    # runs row i and is reported beside it
    k = modular_bwd["natural_residue_B32"]
    line.append({"name": "rope_attention_bwd[short, natural: row 12's backward]", "route": "cuda",
                 "source": meta["rope_attention_bwd"][0],
                 "replaces": "mdgen_finetune_tpu/ops/residue_attention.py:233 (_ra_bwd: jax.vjp "
                             "of _xla_impl(base2=False); the VJP of row 12, pallas_call :183)",
                 "launches": sum(train_natural.values()),
                 "launches_per_step": {f: v["rope_attention_bwd.natural"]
                                       for f, v in train_modular.items()},
                 "likelihood_launches_per_step": hyena_ll["rope_attention_bwd.natural"],
                 "max_abs_err": k["max_abs_err"], "tol": k["tol"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
                 "library_ms": k["library_ms"], "library_note": k["library_note"],
                 "shape": k["shape"], "back_to_back_ms": k["back_to_back_ms"],
                 "host_ms": k["host_ms"], "resources": k["resources"],
                 "q400": {f: v for f, v in modular_bwd["natural_residue_B32_q400"].items()
                          if f != "shape"},
                 "long_route_L32": {f: v for f, v in modular_bwd["natural_long_route_L32"].items()
                                    if f != "shape"}})
    # row 4' (launches: the train_merged run) and row 13 (the probe's run)
    k = merged["T100"]
    line.append({"name": "fused_layer_bwd_merged", "route": "cuda",
                 "source": "mdgen_finetune_tpu_torch/csrc/fused_layer_bwd.cu",
                 "replaces": "mdgen_finetune_tpu/ops/fused_layer_bwd.py:501 (_kmerged, "
                             "pallas_call :646)",
                 "launches": merged_launches["fused_layer_bwd_merged"],
                 "max_abs_err": k["max_abs_err"], "tol": k["tol"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
                 "library_ms": None, "shape": k["shape"], "split_ms": k["split_ms"],
                 "bit_identical_to_split": k["bit_identical_to_split"], "parent": k["parent"],
                 "T200": {f: v for f, v in merged["T200"].items()
                          if f not in ("shape", "phase_clock")}})
    # row c's tensor-core form (ATLAS): launches over the Euler-100 sample
    # (the encoder over the t grid); B = 1 is dopri5's and training's shape
    k = atlas["ipa_attention"]
    line.append({"name": "ipa_attention[tensor-core, ATLAS L = 256]", "route": "cuda",
                 "source": meta["ipa_attention"][0], "replaces": meta["ipa_attention"][1],
                 "launches": atlas_sim_launches["ipa_attention.forms"][3],
                 "train_atlas_launches_per_step": atlas_per_step.get("ipa_attention", 0),
                 "max_abs_err": k["max_abs_err"], "tol": k["tol"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
                 "library_ms": k["library_ms"], "shape": k["shape"],
                 **{f: k[f] for f in ("back_to_back_ms", "library_back_to_back_ms", "host_ms",
                                      "parent", "parent_max_abs_err", "library_note",
                                      "library_max_abs_err", "bounds", "plan", "resources", "form",
                                      "L256_B1", "L256_w16_4_6", "L4")}})
    line.append({"name": "micro_ops", "route": "cuda",
                 "source": "mdgen_finetune_tpu_torch/csrc/micro_ops.cu",
                 "replaces": "tools/micro_ops.py:300 (main: the probe's pallas_call, body kernel)",
                 "launches": probe["launches"], "max_abs_err": probe["max_abs_err"],
                 "tol": probe["tol"], "ms": probe["ms"], "plain_ms": probe["plain_ms"],
                 "bound_ms": probe["bound"][0], "bound_by": probe["bound"][1],
                 "library_ms": probe["library_ms"], "library_note": probe["library_note"],
                 "shape": probe["shape"], "back_to_back_ms": probe["back_to_back_ms"],
                 "bound_32_sms_ms": probe["bound_32_sms_ms"],
                 "parent_ms": probe["parent"]["ms"] if probe["parent"] else None})
    emit({"kernels": line, "card": smi, "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grad-seeds"]:
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
                  file=sys.stderr)
            sys.exit(2)
        grad_seeds(sys.argv[2:])
    else:
        main()

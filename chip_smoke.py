"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``mdgen_finetune_tpu_torch/csrc``
from this checkout, holds each kernel against its plain PyTorch twin at the
shapes of the flagship sampler, checks one denoiser step on the card
against the same step on the CPU, then drives the flagship forward-simulation
sampler at full width (5 layers x 384, 16 heads, prepend-IPA, L = 4, T = 100,
B = 64, 100 Euler steps, bf16, seeded random weights) through
``InferenceEngine.sample`` and a 2-window ``rollout``, and traces one more
sample with ``torch.profiler`` (device time by kernel, idle share). Each
phase prints one JSON line; the kernel line (times, bounds, launches) comes
second to last,
and the last line is ``{"ok": true, "device": {...}}``. Any failed check
raises and the script exits non-zero; without CUDA it exits non-zero before
printing any result.
"""
import dataclasses
import json
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
B, T, L, C, H, NL, STEPS = 64, 100, 4, 384, 16, 5, 100


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


def bound_ms(nbytes, flops, peak_flops=PEAK_BF16_FLOPS):
    """The least time for the work: bytes over the memory rate or operations
    over the peak rate for the inputs' type, whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check(name, got, ref, rel_tol):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    if not (err <= rel_tol * scale) or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: max abs err {err} > {rel_tol} x {scale}")
    return err, rel_tol * scale


def phase_kernels(dev):
    """Each kernel against its plain twin (run in f32 on the same inputs) at
    the main path's shapes; times of kernel, twin and a library yardstick."""
    import torch.nn.functional as F

    from mdgen_finetune_tpu_torch.geometry.rigid import Rigid
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear, adaln_linear_plain
    from mdgen_finetune_tpu_torch.ops.ipa_attention import (
        feat_width, ipa_attention, ipa_attention_plain, proj_width)
    from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention, rope_attention_plain

    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    M = B * T * L

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device=dev) * sc).to(dtype)

    def f(t):
        return None if t is None else t.float()

    out = {}
    # ---- adaln_linear: every use on the main path ----
    x, res = r(M, C), r(M, C)
    sh, scl, gate = r(B, C, sc=0.3), r(B, C, sc=0.3), r(B, C, sc=0.3)
    carry = r(M, 21, dtype=f32)
    uses = {
        "qkv": (x, r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), dict(ln="plain", shift=sh, scale=scl)),
        "out_gate": (x, r(C, C, sc=C ** -0.5), r(C, sc=0.1), dict(epilogue="gate_res", res=res, gate=gate)),
        "fc1_gelu": (x, r(C, 4 * C, sc=C ** -0.5), r(4 * C, sc=0.1),
                     dict(ln="plain", shift=sh, scale=scl, epilogue="gelu")),
        "fc2_gate": (r(M, 4 * C), r(4 * C, C, sc=(4 * C) ** -0.5), r(C, sc=0.1),
                     dict(epilogue="gate_res", res=res, gate=gate)),
        "head_euler": (x, r(C, 21, sc=C ** -0.5), r(21, sc=0.1),
                       dict(ln="plain", shift=sh[:1], scale=scl[:1], epilogue="euler", res=carry, dt=0.01)),
        "embed_add": (r(M, 21, dtype=f32), r(21, C, sc=0.2), None,
                      dict(epilogue="add", add1=r(M, C), add2=r(B * L, C), add2_map=(T * L, L, L))),
        "ipa_proj_affine": (x, r(C, proj_width(4, 32, 8, 8), sc=C ** -0.5), r(proj_width(4, 32, 8, 8), sc=0.1),
                            dict(ln="affine", ln_weight=1 + r(C, sc=0.1, dtype=f32),
                                 ln_bias=r(C, sc=0.1, dtype=f32), out_dtype=f32)),
        "ipa_out": (r(M, feat_width(4, 32, 8)), r(feat_width(4, 32, 8), C, sc=0.06), r(C, sc=0.1),
                    dict(epilogue="gate_res", res=res)),
    }
    errs, use_ms = {}, {}
    for name, (a, w, b, kw) in uses.items():
        got = adaln_linear(a, w, b, **kw)
        kwf = {k: (f(v) if torch.is_tensor(v) and v.dtype == bf else v) for k, v in kw.items()}
        ref = adaln_linear_plain(a.float(), w.float(), f(b), **kwf)
        errs[name] = check(f"adaln_linear[{name}]", got, ref, 1e-2)
        use_ms[name] = time_ms(lambda: adaln_linear(a, w, b, **kw))
    a, w, b, kw = uses["fc1_gelu"]
    Kd, Nd = w.shape
    lib = lambda: F.gelu(torch.addmm(  # noqa: E731
        b, (F.layer_norm(a.float(), (Kd,), eps=1e-6) * (1 + scl.float().repeat_interleave(T * L, 0))
            + sh.float().repeat_interleave(T * L, 0)).to(bf), w))
    out["adaln_linear"] = dict(
        shape=f"fc1: LN+modulate, ({M},{Kd}) @ ({Kd},{Nd}), GELU", uses_ms=use_ms,
        max_abs_err=max(e for e, _ in errs.values()),
        tol={k: t for k, (_, t) in errs.items()},
        ms=use_ms["fc1_gelu"], plain_ms=time_ms(lambda: adaln_linear_plain(a, w, b, **kw)),
        library_ms=time_ms(lib),
        bound=bound_ms(nbytes(a, w, b, sh, scl) + M * Nd * 2, 2.0 * M * Kd * Nd))

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
        stage1_ms=time_ms(lambda: rope_attention(qkv.view(B * T, L, 1, 3 * C), bk, bv,
                                                 mask.view(B * T, L, 1), num_heads=H, base2=True)),
        bound=bound_ms(nbytes(qkv, bk, bv, mask) + B * T * L * C * 2, flops))

    # ---- ipa_attention: the encoder over the whole t grid (S*B elements) ----
    Bn = STEPS * B
    proj = r(Bn, L, proj_width(4, 32, 8, 8), dtype=f32)
    t7 = r(Bn, L, 7, dtype=f32)
    t7[..., 4:] *= 5
    fr = Rigid.from_tensor_7(t7)
    rot, trans = fr.rot.contiguous(), fr.trans.contiguous()
    emask = torch.ones(Bn, L, device=dev)
    emask[::7, -1] = 0
    hw = r(4, dtype=f32)
    kw = dict(H=4, Ch=32, Pq=8, Pv=8)
    got = ipa_attention(proj, rot, trans, emask, hw, **kw)
    ref = ipa_attention_plain(proj, rot, trans, emask, hw, **kw)
    err = check("ipa_attention", got, ref, 1e-2)
    Lq = L * L * 4 * Bn
    out["ipa_attention"] = dict(
        shape=f"{Bn} elements x 4 heads, L={L}, Ch=32, Pq=Pv=8",
        max_abs_err=err[0], tol=err[1],
        ms=time_ms(lambda: ipa_attention(proj, rot, trans, emask, hw, **kw)),
        plain_ms=time_ms(lambda: ipa_attention_plain(proj, rot, trans, emask, hw, **kw)),
        library_ms=None,
        bound=bound_ms(nbytes(proj, rot, trans, emask, hw) + got.numel() * 2,
                       Lq * (2 * 32 + 8 * 3 * 3 + 2 * (32 + 8 * 3)), PEAK_F32_FLOPS))
    emit({"phase": "kernels", "kernels": out})
    return out


def random_engine(dev, cfg, seed):
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
    from mdgen_finetune_tpu_torch.utils.weights import randomize_

    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(seed), scale=0.05)
    return InferenceEngine(cfg, model.state_dict(), device=dev), model.state_dict()


def make_inputs(n, seed, dev):
    """A frame-0 atom14 batch built by the port's own reconstruction."""
    from mdgen_finetune_tpu_torch.geometry import frames as G
    from mdgen_finetune_tpu_torch.geometry.rigid import Rigid

    g = torch.Generator().manual_seed(seed)
    seqres = torch.randint(0, 20, (n, L), generator=g)
    t7 = torch.randn(n, L, 7, generator=g)
    t7[..., 4:] = torch.arange(L)[None, :, None] * 3.8 + t7[..., 4:]
    ang = (torch.rand(n, L, 7, generator=g) * 2 - 1) * torch.pi
    tors = torch.stack([ang.sin(), ang.cos()], -1)
    atom14 = G.frames_torsions_to_atom14(Rigid.from_tensor_7(t7), tors, seqres)
    mask = torch.ones(n, L)
    mask[0, -1] = 0  # one padded residue
    return atom14.to(dev), seqres.to(dev), mask.to(dev)


def ptxas_report(log):
    """Registers / shared memory / spills per compiled kernel, from nvcc -Xptxas -v."""
    if not log.exists():
        return []
    out, name = [], "?"
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1][:48]
        elif "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln):
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}")
    return out


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
    vel = {}
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
        m.flat_call(xc, mk, consts, pack, 1.0, enc=enc[0], mods=mods)
        vel[name] = (xc - zs.to(d)).float().cpu()
    rel = ((vel["cuda"] - vel["cpu"]).norm() / vel["cpu"].norm()).item()
    tol = 5e-2
    emit({"phase": "step_cuda_vs_cpu", "batch": 2, "rel_l2": rel, "tol": tol,
          "velocity_norm_cpu": vel["cpu"].norm().item()})
    if not rel <= tol:
        raise AssertionError(f"card vs CPU step: relative L2 {rel} > {tol}")


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
    t0 = time.perf_counter()
    out, _ = eng.sample(batch, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    per_sample = {fn.__name__: fn.launches for fn in wrappers}
    traj = eng.rollout(atom14, seqres, mask, 2, gen)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    twin_calls = {fn.__name__: fn.cuda_calls for fn in twins}

    traj = torch.from_numpy(traj)
    assert out.shape == (B, T, L, 14, 3) and traj.shape == (B, 2 * T, L, 14, 3)
    assert torch.isfinite(out).all() and torch.isfinite(traj).all(), "non-finite output"
    n_ca, ca_c = bonds(torch.cat([out.cpu(), traj], 1), mask.cpu())
    dev_nca, dev_cac = (n_ca - 1.458).abs().max().item(), (ca_c - 1.522).abs().max().item()
    emit({"phase": "main_path", "B": B, "T": T, "L": L, "C": C, "layers": NL, "steps": STEPS,
          "dtype": "bf16", "sample_s": secs, "steps_per_s": B * STEPS / secs,
          "launches_per_sample": per_sample, "launches": launches,
          "plain_calls_on_card": twin_calls, "rollout_windows": 2,
          "n_ca_mean": n_ca.mean().item(), "ca_c_mean": ca_c.mean().item(),
          "n_ca_max_dev": dev_nca, "ca_c_max_dev": dev_cac})
    if dev_nca > 1e-2 or dev_cac > 1e-2:
        raise AssertionError(f"backbone bonds off: N-CA {dev_nca}, CA-C {dev_cac}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if any(twin_calls.values()):
        raise AssertionError(f"plain twins ran on the card: {twin_calls}")
    return launches, (eng, batch, gen)


KERNEL_OF = (("resident_kernel", "adaln_linear"), ("pipelined_kernel", "adaln_linear"),
             ("tiled64_kernel", "adaln_linear"), ("rope_attention", "rope_attention"),
             ("ipa_attention", "ipa_attention"))


def phase_trace(eng, batch, gen):
    """Where the device time of one flagship sample goes: torch.profiler over
    one ``sample`` call; device time by kernel and the device's idle share of
    the window from the first device activity to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.sample(batch, gen)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        emit({"phase": "trace", "device_time": "not measured (the profiler recorded no device activity)"})
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
    top = sorted(([k, v[0], v[1]] for k, v in by_name.items()), key=lambda r: -r[1])[:8]
    emit({"phase": "trace", "window_ms": window, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / window, "device_ms_by_kernel": by_kernel,
          "top_device_ms_calls": top})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    from mdgen_finetune_tpu_torch.config import (DataConfig, MDGenConfig, ModelConfig,
                                                 TaskConfig, TransportConfig)
    from mdgen_finetune_tpu_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_s = _cuda.build_all()
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": {n: ptxas_report(_cuda.BUILD / f"{n}.log") for n in _cuda.KERNELS}})

    cfg = MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=True),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS))
    kernels = phase_kernels(dev)
    phase_step_across_devices(dev, cfg)
    launches, sampled = phase_main_path(dev, cfg)
    phase_trace(*sampled)

    meta = {
        "adaln_linear": ("mdgen_finetune_tpu_torch/csrc/adaln_linear.cu",
                         "mdgen_finetune_tpu/ops/fused_layer.py:579 + mdgen_finetune_tpu/ops/ipa_encoder.py:441"),
        "rope_attention": ("mdgen_finetune_tpu_torch/csrc/rope_attention.cu",
                           "mdgen_finetune_tpu/ops/fused_layer.py:579 + mdgen_finetune_tpu/ops/ipa_encoder.py:441"),
        "ipa_attention": ("mdgen_finetune_tpu_torch/csrc/ipa_attention.cu",
                          "mdgen_finetune_tpu/ops/ipa_encoder.py:441"),
    }
    line = []
    for name, k in kernels.items():
        src, rep = meta[name]
        line.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"],
                     "shape": k["shape"]})
    emit({"kernels": line, "card": smi, "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

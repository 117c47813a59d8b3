"""PyTorch port, the outsourced UNet policies (``rtb/denoisers.py``) held
to the JAX package's flax modules on the CPU: ``UNetSeqDenoiser``,
``UNet2D`` (class labels; scale-shift with the strided-conv downsample,
and the additive embedding with ``resblock_updown``) and ``UNet3DSeq``
(D = 21 padded to 22; a scalar and a (B,) t; a final Dense from 21 to 8),
forward and the gradients in the input and every parameter, with the weights
carried by ``utils.weights.unet_from_flax`` / ``unet_to_flax``.

Every parameter leaf, the zero-initialised heads included, is drawn from
numpy (N(0, 0.3^2)) in the port's layout; the flax tree it maps to is
checked against ``eval_shape`` of the flax init. One jit a case (the
forward and its gradients). Tolerances: outputs 1e-5 relative L2, input
and parameter gradients 1e-4 relative L2, each parameter's norm floored at
1e-3 of the largest gradient's (the repo's card-vs-CPU rule). The 2-D
cases are 40 channels wide: at 32 or fewer every GroupNorm group holds one
channel, which cancels each conv bias ahead of it and, without scale-shift,
the timestep embedding, so that their gradients are 0 up to rounding and a
relative comparison would compare noise.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.rtb import denoisers as JD
from mdgen_finetune_tpu_torch.rtb import denoisers as TD
from mdgen_finetune_tpu_torch.utils.weights import unet_from_flax, unet_to_flax


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def draw_leaves(module, seed, scale=0.3):
    """Every parameter of ``module`` drawn N(0, scale^2) in numpy (the
    zero-initialised heads too); returns (state_dict, the flax tree)."""
    g = np.random.default_rng(seed)
    sd = {k: torch.from_numpy((g.standard_normal(v.shape) * scale).astype(np.float32))
          for k, v in module.state_dict().items()}
    module.load_state_dict(sd)
    return sd, jax.tree.map(jnp.asarray, unet_to_flax(sd, module))


def same_tree(tree, shapes):
    a = {k: v.shape for k, v in flax.traverse_util.flatten_dict(tree["params"]).items()}
    b = {k: v.shape for k, v in flax.traverse_util.flatten_dict(shapes["params"]).items()}
    assert a == b


UNETS = {
    "unet_seq": dict(
        jax=lambda: JD.UNetSeqDenoiser(out_dim=21, widths=(16, 32)),
        torch=lambda: TD.UNetSeqDenoiser(out_dim=21, widths=(16, 32)),
        x=(2, 3, 6, 21), t=np.array([0.1, 0.7], np.float32), nhwc=False),
    "unet2d_scale_shift": dict(
        jax=lambda: JD.UNet2D(model_channels=40, out_channels=2, num_res_blocks=1,
                              attention_resolutions=(1, 2), channel_mult=(1, 2),
                              num_head_channels=8, num_classes=3, use_scale_shift_norm=True),
        torch=lambda: TD.UNet2D(in_channels=2, model_channels=40, out_channels=2,
                                num_res_blocks=1, attention_resolutions=(1, 2),
                                channel_mult=(1, 2), num_head_channels=8, num_classes=3,
                                use_scale_shift_norm=True),
        x=(2, 8, 8, 2), t=np.array([3.0, 7.0], np.float32), y=np.array([0, 2]), nhwc=True),
    "unet2d_resblock_updown": dict(
        jax=lambda: JD.UNet2D(model_channels=40, out_channels=1, num_res_blocks=1,
                              attention_resolutions=(2,), channel_mult=(1, 2),
                              num_heads=2, num_classes=3, use_scale_shift_norm=False,
                              resblock_updown=True),
        torch=lambda: TD.UNet2D(in_channels=3, model_channels=40, out_channels=1,
                                num_res_blocks=1, attention_resolutions=(2,),
                                channel_mult=(1, 2), num_heads=2, num_classes=3,
                                use_scale_shift_norm=False, resblock_updown=True),
        x=(2, 6, 10, 3), t=np.array([0.0, 12.0], np.float32), y=np.array([1, 1]), nhwc=True),
    "unet3dseq_scalar_t": dict(
        jax=lambda: JD.UNet3DSeq(out_dim=21, model_channels=40, channel_mult=(1, 2),
                                 num_res_blocks=1, attention_resolutions=(2,),
                                 num_head_channels=8),
        torch=lambda: TD.UNet3DSeq(out_dim=21, model_channels=40, channel_mult=(1, 2),
                                   num_res_blocks=1, attention_resolutions=(2,),
                                   num_head_channels=8),
        x=(2, 3, 4, 21), t=np.float32(0.5), nhwc=False),
    "unet3dseq_batch_t": dict(
        jax=lambda: JD.UNet3DSeq(out_dim=8, model_channels=40, channel_mult=(1, 2),
                                 num_res_blocks=1, attention_resolutions=(2,),
                                 num_head_channels=8),
        torch=lambda: TD.UNet3DSeq(out_dim=8, model_channels=40, channel_mult=(1, 2),
                                   num_res_blocks=1, attention_resolutions=(2,),
                                   num_head_channels=8, in_dim=21),
        x=(2, 3, 5, 21), t=np.array([0.2, 0.9], np.float32), nhwc=False),
}


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_forward_and_gradients_match_flax(name):
    case = UNETS[name]
    g = np.random.default_rng(11)
    x = g.normal(size=case["x"]).astype(np.float32)
    y = case.get("y")
    jnet, tnet = case["jax"](), case["torch"]()
    ykw = {} if y is None else {"y": jnp.asarray(y)}
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(x),
                            jnp.asarray(case["t"]), **ykw)
    sd, tree = draw_leaves(tnet, 12)
    same_tree(tree, shapes)
    assert all(v.abs().max() > 0 for v in sd.values())  # no zero head compared
    out_shape = jax.eval_shape(jnet.apply, shapes, jnp.asarray(x), jnp.asarray(case["t"]),
                               **ykw).shape
    w = g.normal(size=out_shape).astype(np.float32)

    def jloss(params, xx):
        out = jnet.apply(params, xx, jnp.asarray(case["t"]), **ykw)
        return jnp.sum(out * w), out

    (_, jout), (jg_params, jg_x) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(tree, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    xin = xt.permute(0, 3, 1, 2) if case["nhwc"] else xt
    out = tnet(xin, torch.as_tensor(case["t"]),
               **({} if y is None else {"y": torch.from_numpy(y)}),
               **({} if case["nhwc"] else {"mask": None, "surplus": 1.0}))
    out = out.permute(0, 2, 3, 1) if case["nhwc"] else out
    (out * torch.from_numpy(w)).sum().backward()
    assert rel_l2(out.detach(), jout) <= 1e-5
    assert rel_l2(xt.grad, jg_x) <= 1e-4
    tg = unet_to_flax({k: p.grad for k, p in tnet.named_parameters()}, tnet)
    jflat = flax.traverse_util.flatten_dict(jax.tree.map(np.asarray, jg_params)["params"])
    tflat = flax.traverse_util.flatten_dict(tg["params"])
    assert set(jflat) == set(tflat)
    floor = 1e-3 * max(np.linalg.norm(v) for v in jflat.values())
    for k, v in jflat.items():
        err = np.linalg.norm(tflat[k] - v) / max(np.linalg.norm(v), floor)
        assert err <= 1e-4, (k, err)
    # the carry is exact both ways
    back = unet_from_flax(jax.tree.map(np.asarray, tree), tnet)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_unet_init_heads_zero_and_flax_names():
    torch.manual_seed(0)
    net = TD.UNet2D(in_channels=2, model_channels=8, out_channels=2, num_res_blocks=1,
                    attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=8,
                    num_classes=3)
    x = torch.randn(2, 2, 8, 8)
    assert torch.equal(net(x, torch.tensor([3.0, 7.0]), y=torch.tensor([0, 2])),
                       torch.zeros(2, 2, 8, 8))
    names = [n for n, _ in net.named_parameters()]
    assert sum(n.endswith("qkv.weight") for n in names) >= 3
    assert any(n.startswith("Downsample2D_0.") for n in names)
    assert any(n.startswith("Upsample2D_0.") for n in names)
    for n, p in net.named_parameters():
        if n.endswith("proj_out.weight") or n == "Conv_1.weight":
            assert not p.any()
    with pytest.raises(ValueError):
        net(x, torch.tensor([3.0, 7.0]))  # num_classes without y
    # computes in its parameters' dtype after .to(), returns f32
    seq = TD.UNet3DSeq(out_dim=8, model_channels=8, num_res_blocks=1, num_head_channels=8,
                       in_dim=21).to(torch.bfloat16)
    out = seq(torch.randn(2, 3, 4, 21), torch.tensor([0.2, 0.9]))
    assert out.dtype == torch.float32 and out.shape == (2, 3, 4, 8) and torch.isfinite(out).all()

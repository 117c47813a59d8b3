"""PyTorch port, the sharding rules of ``parallel/`` held against the JAX
package's, without any process group (pure functions of the mesh's names
and sizes):

- ``kernel_sharding.batch_shard_axes`` and ``seq_shard_axes`` over a grid
  of (dp, sp, batch, seq) against JAX's on ``make_mesh(dp, sp)`` of the
  suite's 8 virtual CPU devices;
- ``split_axes``, the port's choice of layout for a step (the batch fold,
  the sequence split, dp alone, replication), on a (2, 2) mesh;
- ``make_mesh`` in one process: a 1 x 1 mesh, JAX's ``ValueError`` text for
  a mesh that needs more ranks, and ``local_slice`` on a one-rank mesh;
- ``Trainer`` and ``InferenceEngine(mesh=)`` register no mesh for the
  whole process.
"""
import pytest

from mdgen_finetune_tpu.parallel import kernel_sharding as jks
from mdgen_finetune_tpu.parallel.mesh import make_mesh as j_make_mesh
from mdgen_finetune_tpu_torch.parallel import kernel_sharding as tks
from mdgen_finetune_tpu_torch.parallel.mesh import Mesh, local_slice, make_mesh

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4), (8, 1), (1, 8)]


@pytest.mark.parametrize("dp,sp", MESHES)
def test_shard_axes_rules_match_jax(dp, sp):
    jmesh = j_make_mesh(dp, sp)
    shape = {"dp": dp, "sp": sp}
    for batch in range(1, 17):
        assert tks.batch_shard_axes(("dp", "sp"), shape, batch) == \
            jks.batch_shard_axes(jmesh, batch), (batch,)
        for seq in (1, 2, 3, 4, 6, 8, 12, 16, 250, 256):
            assert tks.seq_shard_axes(("dp", "sp"), shape, batch, seq) == \
                jks.seq_shard_axes(jmesh, batch, seq), (batch, seq)


def test_split_axes_chooses_the_layout():
    mesh = Mesh({"dp": 2, "sp": 2}, {"dp": 0, "sp": 0}, {})
    assert tks.split_axes(mesh, 4, 8, 4) == (("dp", "sp"), ())      # batch fold
    assert tks.split_axes(mesh, 2, 8, 4) == (("dp",), ("sp",))      # dp + sequence split
    assert tks.split_axes(mesh, 1, 252, 256) == ((), ("dp", "sp"))  # B = 1
    assert tks.split_axes(mesh, 1, 250, 256) == ((), ("dp",))       # ATLAS: gcd 2
    assert tks.split_axes(mesh, 2, 7, 4) == (("dp",), ())           # T odd: dp alone
    assert tks.split_axes(mesh, 3, 7, 5) == ((), ())                # replication
    one = Mesh({"dp": 1, "sp": 1}, {"dp": 0, "sp": 0}, {})
    assert tks.split_axes(one, 3, 8, 4) == ((), ())


def test_make_mesh_in_one_process():
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.size == 1 and mesh.group(("dp",)) is None
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        make_mesh(1, 2)
    with tks.kernel_mesh(mesh):
        assert tks.get_kernel_mesh() is None
    assert local_slice(mesh, ("dp", "sp"), 6) == slice(0, 6)


def test_trainer_and_engine_register_no_mesh_for_the_process():
    """``Trainer`` and ``InferenceEngine(mesh=)`` leave the registry empty:
    only a step's or a sample's own ``kernel_mesh`` splits the trunk, so a
    call outside them (``log_likelihood``) runs unsplit."""
    from mdgen_finetune_tpu_torch.config import DataConfig, MDGenConfig, ModelConfig
    from mdgen_finetune_tpu_torch.inference import InferenceEngine
    from mdgen_finetune_tpu_torch.training import Trainer

    cfg = MDGenConfig(model=ModelConfig(num_layers=1, embed_dim=32, mha_heads=2, ipa_heads=2,
                                        ipa_head_dim=8, ipa_qk=4, ipa_v=4, use_bf16=False),
                      data=DataConfig(num_frames=8, crop=4))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    InferenceEngine(cfg, state.params, device="cpu", mesh=trainer.mesh)
    assert tks._ACTIVE_MESH[0] is None

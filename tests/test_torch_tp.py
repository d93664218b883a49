"""The port's tensor parallelism (powerserve_tpu_torch/parallel/) on the
CPU: two ranks over gloo, rank 0 this process and rank 1 a follower it
starts (one rank group for the module).

The host re-layout is held bit for bit against the JAX package's
(parallel/tp.py: the QKV and gate|up column orders, the row repack to a
local pack group, param_specs' slices on a 2-device CPU mesh). The
sharded forward is held against the JAX tp_forward on that mesh and
against the port's single rank, and each rank's cache against the
matching heads of the single rank's.

Tolerances: against the port's single rank, 1e-5 of the logits' range:
the rows of wo and down are summed in two partial sums, then added, in
another order than one product's (on this CPU the two orders happen to
give the same bits, and the logits agree exactly). Against JAX (its XLA
route dequantizes in bf16, the port in f32), 3e-2 of the range, as
tests/test_torch_model.py holds the single rank. Each rank's cache
equals its heads of the single rank's cache bit for bit: the first
layer's K/V come from the embedding and column-parallel products, and
the later layers' inputs are those bits as well while the reordered sums
agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.kv.paged import PagePool as JPagePool
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.parallel import tp as jtp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.loops import decode_scan_eager
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.kv.paged import PagePool
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.parallel import tp
from powerserve_tpu_torch.parallel.distributed import check_backend
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 64
SELF_REL = 1e-5
JAX_REL = 3e-2


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_synthetic_gguf(tmp_path_factory.mktemp("tp"), "tiny-k",
                               GGMLType.Q4_K, seed=0, seq_len=SEQ) / "model"


@pytest.fixture(scope="module")
def single(ws):
    return load_gguf_model(ws, device="cpu")


@pytest.fixture(scope="module")
def jmodel(ws):
    return jload(ws)


@pytest.fixture(scope="module")
def ranks():
    group = tp.start_rank_group(2, "gloo", "cpu", threads=2)
    yield group
    group.close()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_column_orders_and_repack_bit_equal_to_jax(single, jmodel):
    cfg, model = single
    jcfg, jparams = jmodel
    llm = cfg.llm
    for t in (1, 2, 4):
        assert np.array_equal(tp._qkv_perm(4, 2, 64, t),
                              jtp._qkv_perm(4, 2, 64, t))
        assert np.array_equal(tp._gu_perm(512, t), jtp._gu_perm(512, t))
    jprep = jtp.prepare_params_for_tp(jparams, jcfg.llm, 2)
    prep = tp.prepare_params_for_tp(model, 2)
    down = prep.layers[0].w_down
    # K = 512 packed in one group of 512: each rank's 256 needs a repack
    assert model.layers[0].w_down.pack_group == 512
    assert down.pack_group == 256 == jprep.layers.w_down.pack_group
    for i, lw in enumerate(prep.layers):
        for name in ("wqkv", "wgu", "wo", "w_down"):
            mine, ref = getattr(lw, name), getattr(jprep.layers, name)
            for part in ("q", "scales", "bias"):
                assert np.array_equal(
                    getattr(mine, part).numpy(),
                    np.asarray(getattr(ref, part)[i])), (name, part)
    # the raw nibbles survive the repack
    lin = model.layers[1].w_down
    raw = tp._unpack_nib(lin.q, lin.pack_group)
    assert torch.equal(tp._unpack_nib(tp._pack_nib(raw, 128), 128), raw)
    with pytest.raises(ValueError, match="row-shardable"):
        tp._repack_rows(model.layers[0].wo, 3)
    assert tp.local_llm_config(llm, 2).n_kv_heads == 1


def test_shards_are_param_specs_slices(single, jmodel):
    """Rank r's shard of every weight is the slice JAX's param_specs puts
    on device r of a 2-device tp mesh."""
    cfg, model = single
    jcfg, jparams = jmodel
    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jsharded = jtp.shard_params_tp(jparams, mesh, jcfg.llm)

    def on(arr, r):
        dev = mesh.devices.flat[r]
        return next(np.asarray(s.data) for s in arr.addressable_shards
                    if s.device == dev)

    for r in range(2):
        local = tp.shard_params_tp(model, r, 2)
        assert local.llm.n_heads == 2 and local.llm.n_kv_heads == 1
        for i, lw in enumerate(local.layers):
            for name in ("wqkv", "wgu", "wo", "w_down"):
                mine, ref = getattr(lw, name), getattr(jsharded.layers, name)
                for part in ("q", "scales", "bias"):
                    assert np.array_equal(getattr(mine, part).numpy(),
                                          on(getattr(ref, part), r)[i]), (
                        r, name, part)
            assert np.array_equal(lw.attn_norm.numpy(),
                                  on(jsharded.layers.attn_norm, r)[i])
        for part in ("q", "scales"):
            assert np.array_equal(getattr(local.embed, part).numpy(),
                                  on(getattr(jsharded.embed, part), r))
            assert np.array_equal(getattr(local.lm_head, part).numpy(),
                                  on(getattr(jsharded.lm_head, part), r))
        assert local.lm_head.out_features == 256
        assert np.array_equal(local.out_norm.numpy(),
                              on(jsharded.out_norm, r))


def _jax_tp(jmodel, tokens, positions, steps):
    """JAX's tp_forward on a 2-device mesh: prefill logits, then the
    logits of each decode step in `steps` ([S] token arrays)."""
    jcfg, jparams = jmodel
    llm = jcfg.llm
    mesh = make_mesh({"tp": 2}, devices=jax.devices()[:2])
    p2 = jtp.shard_params_tp(jparams, mesh, llm)
    kv = jtp.shard_kv_tp(JKVCache.create(llm.n_layers, tokens.shape[0], SEQ,
                                         llm.n_kv_heads, llm.head_size), mesh)
    fwd = jax.jit(lambda p, kv, t, pos: jtp.tp_forward(
        p, llm, kv, t, pos, mesh=mesh, backend="xla"))
    logits, kv = fwd(p2, kv, jnp.asarray(tokens), jnp.asarray(positions))
    out = [np.asarray(logits)]
    pos = positions[:, -1:] + 1
    for tok in steps:
        logits, kv = fwd(p2, kv, jnp.asarray(tok[:, None]), jnp.asarray(pos))
        out.append(np.asarray(logits))
        pos = pos + 1
    return out


def test_tp_forward_against_jax_and_the_single_rank(single, jmodel, ranks,
                                                    ws):
    cfg, model = single
    llm = cfg.llm
    tcfg, tmodel = ranks.load(ws, 2)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    rng = np.random.default_rng(0)
    # 20 rows: a prefill chunk (flash-prefill), then decode steps
    tokens = rng.integers(0, llm.vocab_size, (2, 20))
    positions = np.broadcast_to(np.arange(20), (2, 20)).copy()
    kv1 = KVCache.create(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                         llm.head_size, "cpu")
    kv2 = tmodel.create_cache(llm.n_layers, 2, SEQ, llm.n_kv_heads,
                              llm.head_size)
    args = (torch.from_numpy(tokens), torch.from_numpy(positions))
    want = model(kv1, *args, logits_mode="last")
    got = tp.tp_prefill(tmodel, *args, kv2)
    assert _rel(got, want) <= SELF_REL
    step = want.argmax(-1)
    pos = torch.full((2, 1), 20)
    want_d = model(kv1, step[:, None], pos, logits_mode="last")
    got_d = tp.tp_forward(tmodel, kv2, step[:, None], pos, logits_mode="last")
    assert _rel(got_d, want_d) <= SELF_REL
    jprefill, jdecode = _jax_tp(jmodel, tokens, positions, [step.numpy()])
    assert _rel(got, jprefill) <= JAX_REL
    assert _rel(got_d, jdecode) <= JAX_REL
    # every rank's cache: its heads of the single rank's, bit for bit
    whole = kv2.gathered()
    assert torch.equal(whole["pos"], kv1.pos)
    assert torch.equal(whole["mask"], kv1.mask)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(whole[name], getattr(kv1, name)), name
    # greedy decode: the same tokens as the single rank's
    nxt = want_d.argmax(-1)
    assert torch.equal(tp.tp_decode_scan(tmodel, nxt, kv2, 8),
                       decode_scan_eager(model, nxt, kv1, 8))
    after = kv2.gathered()
    assert torch.equal(after["pos"], kv1.pos)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(after[name], getattr(kv1, name)), name


def test_vocab_sharded_argmax(ranks, ws, single):
    """The greedy head over a vocab split in two ranks: each rank's (max,
    index), reduced, is the argmax over the whole vocab."""
    cfg, model = single
    llm = cfg.llm
    _, tmodel = ranks.load(ws, 2)
    assert tmodel.shard.model.lm_head.out_features == llm.vocab_size // 2
    tok = torch.arange(1, 9)[:, None]
    pos = torch.zeros(8, 1, dtype=torch.int64)
    want = model(KVCache.create(llm.n_layers, 8, SEQ, llm.n_kv_heads,
                                llm.head_size, "cpu"), tok, pos,
                 logits_mode="last")
    got = tmodel(tmodel.create_cache(llm.n_layers, 8, SEQ, llm.n_kv_heads,
                                     llm.head_size), tok, pos,
                 logits_mode="argmax")
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), want.argmax(-1))
    # both halves of the vocab hold a winner among these rows
    assert (want.argmax(-1) < llm.vocab_size // 2).any()
    assert (want.argmax(-1) >= llm.vocab_size // 2).any()


def test_page_pool_groups_match_jax():
    """PagePool(n_groups=2): each slot's pages from its group's partition;
    the same grants as JAX's pool, op for op."""
    mine = PagePool(8, 4, 4, 8, n_groups=2)
    ref = JPagePool(n_pages=8, n_slots=4, max_pages=4, page_size=8,
                    n_groups=2)
    ops = [("ensure", 0, 32), ("ensure", 1, 8), ("ensure", 2, 32),
           ("release", 0), ("ensure", 1, 16), ("ensure", 3, 9),
           ("release", 2), ("ensure", 3, 30)]
    for op, *a in ops:
        got = getattr(mine, op)(*a)
        want = getattr(ref, op)(*a)
        assert got == want, (op, a)
        assert np.array_equal(mine.table, ref.table), (op, a)
        assert mine.owned == ref.owned
        assert mine.n_free == ref.n_free
    assert mine.group_of(2) == 1 and mine.n_free_for(0) == ref.n_free_for(0)
    assert all(p < 4 for p in mine.owned[1])
    with pytest.raises(ValueError, match="dp groups"):
        PagePool(9, 4, 4, 8, n_groups=2)


def test_backends_are_named_not_chosen():
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", 2, "cpu")
    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="nccl or gloo"):
        check_backend("mpi", 2, "cpu")
    check_backend("gloo", 4, "cpu")

"""The port's sequence parallelism on the CPU: the state modes' twins
(ops/flash_decode.py, ops/flash_prefill.py: state=True with a key offset
t0) against the JAX package's _chunked_quant_mlo over the same slice,
the merge (ops/attention.py gqa_attention_quant_sp) over two gloo
processes against JAX's gqa_attention_quant_sp on an {"sp": 2} mesh, and
a tp = 2 x sp = 2 model (one rank group of four for the module: rank 0
this process, ranks 1-3 followers) against JAX's tp x sp forward and the
port's single rank, its scheduler, and the refusals.

Tolerances. The twins against JAX's one-chunk state: m within 1e-5, l
and o within 3e-3 of their range (the twins walk 16- or 64-token steps,
so p * vs is rounded to bf16 at other running maxima, ~2^-9 relative,
as tests/test_torch_flash_decode_state.py holds the paged state mode).
A row that sees none of the slice: the port's m = -1e30, l = 0, o = 0
(JAX's state averages V there; its merge weighs that 0). The merge
against JAX's: 3e-3 of the output's range, for the same reason. The
tp x sp forward against JAX's, 3e-2 of the logits' range (JAX's XLA
route dequantizes in bf16), as tests/test_torch_tp.py holds tp; against
the port's single rank, 2e-2: each slice's softmax rounds p * vs at its
own running maximum, and the merged layer outputs feed the next layer's
cache quantization. Greedy tokens follow the near-tie rule (a stream may
part from the single rank's only where its teacher-forced top-2 gap is
< 0.5).
"""

import os
import queue
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models.loader import load_gguf_model as jload
from powerserve_tpu.ops import attention as jattn
from powerserve_tpu.parallel import tp as jtp
from powerserve_tpu.parallel.mesh import make_mesh
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.engine.generator import InferenceEngine
from powerserve_tpu_torch.engine.scheduler import BatchScheduler, Request
from powerserve_tpu_torch.kv.cache import KVCache, SeqShardCache
from powerserve_tpu_torch.models.loader import load_gguf_model
from powerserve_tpu_torch.ops.attention import NEG_INF, build_visibility
from powerserve_tpu_torch.ops.flash_decode import flash_decode_quant
from powerserve_tpu_torch.ops.flash_prefill import flash_prefill_quant
from powerserve_tpu_torch.parallel import tp
from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
H, HKV, D = 8, 2, 32
SCALE = 0.2
SEQ = 64
NEAR_TIE = 0.5


def _slice(rng, S, T):
    kq = rng.integers(-127, 128, (S, HKV, T, D), dtype=np.int8)
    vq = rng.integers(-127, 128, (S, HKV, T, D), dtype=np.int8)
    ks = rng.uniform(0.005, 0.02, (S, HKV, T)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (S, HKV, T)).astype(np.float32)
    return kq, ks, vq, vs


# (Tq, the slot's global positions of this batch's first row, t0, the
# committed positions before the batch, T of the slice)
STATE_CASES = {
    "decode_offset": (1, [70, 90], 64, [70, 90], 64),
    "decode_chain": (3, [100, 64], 64, [100, 64], 64),
    "decode_empty_shard": (2, [20, 40], 64, [20, 40], 64),
    "prefill_offset": (24, [64, 80], 64, [64, 80], 64),
    "prefill_straddle": (24, [50, 60], 64, [50, 60], 64),
    "prefill_empty_shard": (24, [10, 0], 64, [10, 0], 64),
}


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_state_twins_match_jax_state(case):
    """Each state mode's twin over a slice [t0, t0 + T) against JAX's
    _chunked_quant_mlo over the same slice with the visibility JAX's sp
    forward builds (build_visibility of the slice's mask and the local
    cache positions, other shards' at -1)."""
    Tq, first, t0, committed, T = STATE_CASES[case]
    S = len(first)
    rng = np.random.default_rng(sum(first) + Tq)
    kq, ks, vq, vs = _slice(rng, S, T)
    q = rng.standard_normal((S, Tq, H, D)).astype(np.float32)
    pos = np.asarray(first)[:, None] + np.arange(Tq)[None, :]
    cols = t0 + np.arange(T)
    mask = cols[None, :] < np.asarray(committed)[:, None]
    local = np.where((pos >= t0) & (pos < t0 + T), pos - t0, -1)
    vis = build_visibility(torch.as_tensor(mask), torch.as_tensor(local))
    args = [torch.as_tensor(a) for a in (q, kq, ks, vq, vs, mask)]
    if Tq > 16:
        o, m, l = flash_prefill_quant(*args, torch.as_tensor(pos[:, 0]),
                                      SCALE, state=True, t0=t0)
    else:
        o, m, l = flash_decode_quant(*args, torch.as_tensor(pos), SCALE,
                                     state=True, t0=t0)
    G = H // HKV
    qg = jnp.asarray(q).reshape(S, Tq, HKV, G, D).astype(jnp.bfloat16)
    jm, jl, jo = (np.asarray(a) for a in jattn._chunked_quant_mlo(
        qg, jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), jnp.asarray(vis.numpy()), SCALE, T))
    jm, jl, jo = jm.reshape(S, -1), jl.reshape(S, -1), jo.reshape(S, -1, D)
    assert o.shape == (S, H * Tq, D) and m.shape == l.shape == (S, H * Tq)
    # rows (h, g, tq): which of them see the slice at all
    seen = vis.any(dim=-1).numpy()  # [S, Tq]
    seen = np.broadcast_to(seen[:, None, :], (S, H, Tq)).reshape(S, -1)
    m, l, o = m.numpy(), l.numpy(), o.numpy()
    if seen.any():
        np.testing.assert_allclose(m[seen], jm[seen], rtol=1e-5, atol=1e-5)
        assert (np.abs(l[seen] - jl[seen]).max()
                <= 3e-3 * np.abs(jl[seen]).max())
        assert (np.abs(o[seen] - jo[seen]).max()
                <= 3e-3 * np.abs(jo[seen]).max())
    assert (m[~seen] == NEG_INF).all() and (l[~seen] == 0).all()
    assert (o[~seen] == 0).all()
    if "empty" in case:
        assert (~seen).any()


_MERGE_SCRIPT = r"""
import sys, numpy as np, torch, torch.distributed as dist
from powerserve_tpu_torch.ops.attention import gqa_attention_quant_sp
from powerserve_tpu_torch.parallel.mesh import TPComm
rank, addr, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=2)
d = np.load(path)
T = d["kq"].shape[2] // 2
cut = slice(rank * T, (rank + 1) * T)
t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
comm = TPComm(dist.group.WORLD, rank, 2, "gloo")
outs = [gqa_attention_quant_sp(
    t(d["q" + k]), t(d["kq"][:, :, cut]), t(d["ks"][:, :, cut]),
    t(d["vq"][:, :, cut]), t(d["vs"][:, :, cut]), t(d["mask"][:, cut]),
    t(d["pos" + k]), float(d["scale"]), comm, rank * T,
    prefill=k == "p").numpy() for k in ("d", "p")]
np.savez(path + f".{rank}.npz", d=outs[0], p=outs[1])
dist.destroy_process_group()
"""


def test_sp_attention_over_two_ranks_matches_jax():
    """gqa_attention_quant_sp over two gloo processes (each its half of
    the time axis; decode at Tq = 2, a prefill chunk at Tq = 24 that
    straddles the halves) against JAX's gqa_attention_quant_sp on an
    {"sp": 2} mesh: the same output on both ranks."""
    from powerserve_tpu_torch.parallel.distributed import free_port

    rng = np.random.default_rng(3)
    S, T = 2, 128
    kq, ks, vq, vs = _slice(rng, S, T)
    committed = np.asarray([50, 100])
    mask = np.arange(T)[None, :] < committed[:, None]
    batch = {"d": 2, "p": 24}
    data = dict(kq=kq, ks=ks, vq=vq, vs=vs, mask=mask, scale=SCALE)
    for k, tq in batch.items():
        data["q" + k] = rng.standard_normal((S, tq, H, D)).astype(np.float32)
        data["pos" + k] = committed[:, None] + np.arange(tq)[None, :]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "in.npz")
        np.savez(path, **data)
        addr = f"tcp://127.0.0.1:{free_port()}"
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        procs = [subprocess.Popen([sys.executable, "-c", _MERGE_SCRIPT,
                                   str(r), addr, path], env=env)
                 for r in range(2)]
        assert all(p.wait(timeout=120) == 0 for p in procs)
        got = [np.load(path + f".{r}.npz") for r in range(2)]
    mesh = make_mesh({"sp": 2}, devices=jax.devices()[:2])
    from jax.sharding import PartitionSpec as P

    for k in batch:
        assert np.array_equal(got[0][k], got[1][k])
        q, pos = data["q" + k], data["pos" + k]
        vis = build_visibility(torch.as_tensor(mask),
                               torch.as_tensor(pos)).numpy()
        f = jax.shard_map(
            lambda q, kq, ks, vq, vs, vis: jattn.gqa_attention_quant_sp(
                q, kq, ks, vq, vs, vis, SCALE, "sp", chunk=T // 2),
            mesh=mesh,
            in_specs=(P(), P(None, None, "sp"), P(None, None, "sp"),
                      P(None, None, "sp"), P(None, None, "sp"),
                      P(None, None, "sp")),
            out_specs=P(), check_vma=False)
        want = np.asarray(f(*(jnp.asarray(a) for a in (
            q, kq, ks, vq, vs, vis))))
        assert got[0][k].shape == want.shape
        assert np.abs(got[0][k] - want).max() <= 3e-3 * np.abs(want).max()


class _ThreadComm:
    """One rank of an in-process sp group whose ranks are threads: the
    all_reduce sums every rank's tensor (as a TPComm over gloo does)."""

    def __init__(self, shared: dict, rank: int):
        self.shared, self.rank = shared, rank

    def all_reduce(self, t, op="sum"):
        sh = self.shared
        sh["parts"][self.rank] = t.clone()
        sh["barrier"].wait()
        total = sum(sh["parts"])
        sh["barrier"].wait()
        return t.copy_(total)


def _on_ranks(parts, fn):
    """fn(part) on every part at once, one thread a rank."""
    errors = []

    def run(c):
        try:
            fn(c)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,), daemon=True)
               for c in parts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_seq_shard_cache_keeps_global_positions():
    """Writes land on the rank whose slice holds them, pos counts every
    in-range position on every rank, rollback and the prefix snapshots
    work in global positions; the token-tree operations too: set_mask
    acts on the slice's positions, and a commit whose accepted entries
    lie on the other slice than their destinations moves their bytes
    there (two ranks as threads over an in-process sum)."""
    full = KVCache.create(1, 2, 16, 1, 4, "cpu")
    shared = {"parts": [None, None],
              "barrier": threading.Barrier(2, timeout=60)}
    parts = [SeqShardCache.create(1, 2, 16, 1, 4, "cpu", sp=2, sp_rank=r,
                                  comm=_ThreadComm(shared, r))
             for r in range(2)]
    pos = torch.tensor([[5, 6, 7, 8, 9], [-1, 14, 15, 16, -1]])
    k = torch.randn(2, 5, 1, 4)
    for c in [full] + parts:
        c.write(0, k, k, c.write_index(pos))
        c.advance(pos)
    for r, c in enumerate(parts):
        assert torch.equal(c.pos, full.pos)
        assert torch.equal(c.mask, full.mask[:, 8 * r:8 * r + 8])
        assert torch.equal(c.k, full.k[:, :, :, 8 * r:8 * r + 8])
        snap = c.save_slot_prefix(0, 9)
        assert snap["k"].shape[2] == (8, 1)[r]
        c.rollback(3)
        assert torch.equal(c.mask, (c.t0 + torch.arange(8) < torch.tensor(
            [2, 0])[:, None]) & c.mask)
        c.restore_slot_prefix(1, snap)
        assert int(c.pos[1]) == 9
    snap = full.save_slot_prefix(0, 9)
    full.rollback(3)
    full.restore_slot_prefix(1, snap)
    # a tree of 5 nodes from 6 in slot 0 (across the boundary at 8) and
    # from 12 in slot 1; slot 0 accepts nodes 0, 3, 4 (at 6, 9, 10: to
    # 6, 7, 8), slot 1 nodes 0, 2 (at 12, 14: to 12, 13)
    full.rollback(full.pos.long() - torch.tensor([6, 12]))
    for c in parts:
        c.rollback(c.pos.long() - torch.tensor([6, 12]))
    tree = torch.tensor([[6, 7, 8, 9, 10], [12, 13, 14, 15, 16]])
    k = torch.randn(2, 5, 1, 4)
    for c in [full] + parts:
        c.write(0, k, -k, c.write_index(tree))
        c.advance(tree, visible=torch.zeros(2, 5, dtype=torch.bool))
    src = torch.tensor([[6, 9, 10], [12, 14, -1]])
    n_acc = torch.tensor([3, 2])
    full.rollback(full.pos.long() - torch.tensor([6, 12]))
    full.commit_tokens(None, src, n_acc)
    full.set_mask(1, torch.tensor([3, 9]), False)
    full.copy_token(0, torch.tensor(11), torch.tensor(7))

    def tree_ops(c):
        c.rollback(c.pos.long() - torch.tensor([6, 12]))
        c.commit_tokens(None, src, n_acc)
        c.set_mask(1, torch.tensor([3, 9]), False)
        c.copy_token(0, torch.tensor(11), torch.tensor(7))

    _on_ranks(parts, tree_ops)
    assert full.pos.tolist() == [9, 14]
    for r, c in enumerate(parts):
        cut = slice(8 * r, 8 * r + 8)
        assert torch.equal(c.pos, full.pos)
        assert torch.equal(c.mask, full.mask[:, cut])
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(c, name),
                               getattr(full, name)[:, :, :, cut]), name


# -- tp = 2 x sp = 2 over a rank group ------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """"model" (tiny-k Q4_K), "draft" (another seed)."""
    r = tmp_path_factory.mktemp("spserve")
    make_synthetic_gguf(r, "tiny-k", GGMLType.Q4_K, seed=0, seq_len=SEQ)
    w = make_synthetic_gguf(tmp_path_factory.mktemp("draft"), "tiny-k",
                            GGMLType.Q4_K, seed=7, seq_len=SEQ)
    (w / "model").rename(r / "draft")
    return r


@pytest.fixture(scope="module")
def single(root):
    cfg, model = load_gguf_model(root / "model", device="cpu")
    hp = HyperParams(max_slots=1, batch_size=8, max_seq_len=SEQ)
    hp.sampler.temperature = 0.0
    return cfg, model, InferenceEngine(model, cfg, hp, device="cpu")


@pytest.fixture(scope="module")
def ranks(root):
    group = tp.start_rank_group(4, "gloo", "cpu", threads=1)
    model = group.load(root / "model", 2, sp=2)[1]
    yield group, model
    group.close()


def _near_tie(got, want, prompt, single):
    """got equals want, or first parts where the single rank's
    teacher-forced top-2 gap is < NEAR_TIE."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert len(got) == len(want), (got, want)
        return
    engine = single[2]
    engine.reset()
    top2 = engine.prefill(list(prompt) + list(want[:i])).topk(2).values
    assert float(top2[0] - top2[1]) < NEAR_TIE, (i, got, want)


def test_tp_sp_forward_and_decode_match_jax_and_single(root, single, ranks):
    """A 20-token prefill over tp = 2 x sp = 2 (32 positions a rank) then
    greedy decode steps that cross into the second slice: logits against
    JAX's tp_forward on a {"sp": 2, "tp": 2} mesh and the single rank,
    tokens against both (near-tie rule), and the cache put together over
    tp and sp: mask and pos the single rank's, the first layer's K/V bit
    for bit (the embedding's projections; later layers' inputs carry the
    merge's roundings)."""
    group, model = ranks
    cfg, one, _ = single
    llm = cfg.llm
    S, C, steps = 2, 20, 16
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, llm.vocab_size, (S, C)))
    pos = torch.arange(C)[None].expand(S, C)
    args = (llm.n_layers, S, SEQ, llm.n_kv_heads, llm.head_size)
    kv1 = KVCache.create(*args, "cpu")
    kv = model.create_cache(*args)
    want = one(kv1, tokens, pos, logits_mode="last")
    got = model(kv, tokens, pos, logits_mode="last")
    rng_ = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-2 * rng_

    jcfg, jparams = jload(root / "model")
    mesh = make_mesh({"sp": 2, "tp": 2}, devices=jax.devices()[:4])
    jp = jtp.shard_params_tp(jparams, mesh, jcfg.llm)
    jkv = jtp.shard_kv_tp(JKVCache.create(*args), mesh)
    jlog, jkv = jtp.tp_forward(jp, jcfg.llm, jkv, jnp.asarray(tokens.numpy()),
                               jnp.asarray(pos.numpy()), mesh=mesh,
                               backend="xla")
    jlog = np.asarray(jlog)
    assert np.abs(got.numpy() - jlog).max() <= 3e-2 * np.abs(jlog).max()

    first = want.argmax(-1).to(torch.int32)
    mine = tp.tp_decode_scan(model, first, kv, steps)
    toks, tok = [], first
    for _ in range(steps):
        tok = one(kv1, tok[:, None], kv1.pos.long()[:, None],
                  logits_mode="argmax")
        toks.append(tok)
    ref = torch.stack(toks, 1)
    jtoks, _ = jtp.tp_decode_scan(jp, jnp.asarray(first.numpy()), jkv,
                                  jcfg.llm, steps, mesh, "xla")
    for s in range(S):
        prompt = tokens[s].tolist() + [int(first[s])]
        _near_tie(mine[s].tolist(), ref[s].tolist(), prompt, single)
        _near_tie(np.asarray(jtoks)[s].tolist(), ref[s].tolist(), prompt,
                  single)
    whole = kv.gathered()
    assert torch.equal(whole["pos"], kv1.pos)
    assert torch.equal(whole["mask"], kv1.mask)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert whole[name].shape == getattr(kv1, name).shape
        assert torch.equal(whole[name][0], getattr(kv1, name)[0]), name


def _hp(**kw) -> HyperParams:
    return HyperParams(max_slots=2, batch_size=8, max_seq_len=SEQ, spec_k=3,
                       **kw)


PROMPTS = [[3, 5, 7, 9, 11], list(range(20, 45))]


def _stepwise(sched, prompts, max_tokens=10):
    outs, dones = [], []
    for p in prompts:
        out, done = [], queue.Queue()

        def sink(t, out=out, done=done):
            done.put(True) if t is None else out.append(t)

        sched.submit(Request(prompt_ids=list(p), max_tokens=max_tokens,
                             temperature=0.0, sink=sink))
        outs.append(out)
        dones.append(done)
    for _ in range(2000):
        if all(not d.empty() for d in dones):
            break
        sched.step()
    assert all(not d.empty() for d in dones), "requests did not finish"
    return outs


@pytest.mark.parametrize("case", ["plain", "chain_draft_dir", "chain_self"])
def test_sp_scheduler_gives_the_single_ranks_tokens(root, single, ranks,
                                                    case):
    """Plain ticks and a draft model's chain (a draft dir, a 1-layer
    self-draft) over tp = 2 x sp = 2 on the dense cache: the single
    rank's plain tokens (near-tie rule)."""
    group, model = ranks
    cfg, one, _ = single
    want = _stepwise(BatchScheduler(one, cfg, _hp(), "cpu"), PROMPTS)
    draft = {"plain": None,
             "chain_draft_dir": lambda: group.load(root / "draft", 2,
                                                   sp=2)[1],
             "chain_self": lambda: group.self_draft(model, 1)}[case]
    sched = BatchScheduler(model, cfg, _hp(), "cpu",
                           draft=None if draft is None else draft())
    got = _stepwise(sched, PROMPTS)
    for g, w, p in zip(got, want, PROMPTS):
        _near_tie(g, w, p, single)
    if draft is not None:
        assert sched.n_spec_steps > 0


def test_sp_refusals(root, single, ranks):
    """The pool under sp is refused (JAX asserts "paged KV + sequence
    parallel unsupported"); serve --sp with --paged-pages exits 2. Token
    trees and EAGLE heads under sp serve
    (tests/test_torch_sp_compositions.py)."""
    _, model = ranks
    cfg = single[0]
    with pytest.raises(ValueError, match="paged KV"):
        BatchScheduler(model, cfg, _hp(paged_pages=16, page_size=8), "cpu")
    out = subprocess.run(
        [sys.executable, "-m", "powerserve_tpu_torch", "serve", "-d",
         str(root), "--device", "cpu", "--tp", "2", "--sp", "2",
         "--paged-pages", "16"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2 and "paged KV" in out.stderr

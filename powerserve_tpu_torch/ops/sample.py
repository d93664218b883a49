"""The sampler's draws from per-slot Philox4x32-10 streams
(csrc/sample.cu), and their plain PyTorch twins.

The JAX package draws with jax.random under jit (categorical, uniform,
gumbel), with a key per slot split inside its scans. The port keeps
each slot's stream in two int64 buffers on the device: seed [S] (the
Philox key, written at admission) and counter [S] (the slot's draws so
far). A call of R rows draws for R / S rows a slot: row r belongs to
slot r // m (m = R / S) and makes draw number counter[slot] + r % m;
the call then adds m to every slot's counter, in place. Each value of
a draw is therefore a function of the slot's seed, its counter and the
value's index alone: a request's draws depend neither on its slot nor on
the other slots, and a CUDA graph that captured a call draws anew at
every replay.

Element e of a draw is word e % 4 of the Philox4x32-10 block with
counter words (e // 4 low, e // 4 high, draw low, draw high) and key
words (seed low, seed high); a uniform is (word >> 8) * 2^-24, exact in
f32. The twins compute those words in int64 torch ops masked to 32 bits
(the 32 x 32-bit products in 16-bit limbs, so nothing overflows), so
uniforms and Gumbel noise are bit-equal to the kernel's; a categorical
draw takes the first index whose CDF exceeds u * total, where the
kernel's block scan and torch.cumsum add in another order (a token may
differ only where u * total lies within that rounding of a CDF
boundary).

Three modes, each a wrapper that runs its twin for CPU tensors and
launches the kernel (or raises) for CUDA tensors:
  sample_categorical(dist [R, V]) -> int64 [R]
  sample_uniform(seed, counter, R, n) -> f32 [R, n] in [0, 1)
  sample_gumbel(seed, counter, R, n) -> f32 [R, n], -log(-log(u))
"""

from __future__ import annotations

import torch

from . import cuda_lib

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MODES = {"categorical": 0, "uniform": 1, "gumbel": 2}


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m for a < 2^32 (int64) and the
    constant m < 2^32, in 16-bit limbs (every product < 2^33)."""
    a0, a1 = a & 0xFFFF, a >> 16
    m0, m1 = m & 0xFFFF, m >> 16
    mid = a0 * m1 + a1 * m0
    t = a0 * m0 + ((mid & 0xFFFF) << 16)
    return a1 * m1 + (mid >> 16) + (t >> 32), t & MASK32


def philox4x32_10(ctr: tuple, key: tuple) -> tuple:
    """Philox4x32-10 (Random123) on int64 tensors holding 32-bit words:
    ctr 4 words, key 2 words (broadcasting) -> 4 words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The low and high 32-bit words of int64 values."""
    return t & MASK32, (t >> 32) & MASK32


def draw_words(seed: torch.Tensor, draw: torch.Tensor,
               block: torch.Tensor) -> torch.Tensor:
    """The 4 words [..., 4] (int64) of Philox block `block` of draw
    number `draw` under key `seed` (int64, broadcasting)."""
    seed, draw, block = torch.broadcast_tensors(seed, draw, block)
    out = philox4x32_10((*_words(block), *_words(draw)), _words(seed))
    return torch.stack(out, dim=-1)


def unit_floats(words: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1): (word >> 8) * 2^-24, exact in f32."""
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def _rows(seed: torch.Tensor, counter: torch.Tensor, R: int
          ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Each row's seed and draw number [R], and the rows a slot (m)."""
    S = seed.shape[0]
    if S == 0 or R % S:
        raise ValueError(f"{R} rows do not split over {S} slots")
    m = R // S
    r = torch.arange(R, device=seed.device)
    return seed[r // m], counter[r // m] + r % m, m


def uniform_reference(seed: torch.Tensor, counter: torch.Tensor, R: int,
                      n: int) -> torch.Tensor:
    """sample_uniform's twin: f32 [R, n]; advances counter by R / S."""
    s, d, m = _rows(seed, counter, R)
    nblk = -(-n // 4)
    blocks = torch.arange(nblk, device=seed.device)
    words = draw_words(s[:, None], d[:, None], blocks[None, :])
    counter += m
    return unit_floats(words.reshape(R, 4 * nblk)[:, :n])


def gumbel_reference(seed: torch.Tensor, counter: torch.Tensor, R: int,
                     n: int) -> torch.Tensor:
    """sample_gumbel's twin: -log(-log(max(u, 1e-20))) f32 [R, n]."""
    u = uniform_reference(seed, counter, R, n)
    return -torch.log(-torch.log(u.clamp(min=1e-20)))


def categorical_reference(dist: torch.Tensor, seed: torch.Tensor,
                          counter: torch.Tensor) -> torch.Tensor:
    """sample_categorical's twin: one draw per row of dist [R, V] (f32,
    non-negative) -> int64 [R]: the first index with mass whose CDF
    exceeds u * total (past the last, by rounding: the last index with
    mass; 0 for a row without any). Advances counter by R / S."""
    R, V = dist.shape
    s, d, m = _rows(seed, counter, R)
    u = unit_floats(draw_words(s, d, torch.zeros_like(d))[:, 0])
    dist = dist.float()
    target = u * dist.sum(dim=-1)
    mass = dist > 0
    over = (dist.cumsum(dim=-1) > target[:, None]) & mass
    first = torch.argmax(over.int(), dim=-1)
    last = V - 1 - torch.argmax(mass.flip(-1).int(), dim=-1)
    last = torch.where(mass.any(dim=-1), last, 0)
    counter += m
    return torch.where(over.any(dim=-1), first, last)


def _launch(mode: str, dist: torch.Tensor | None, out: torch.Tensor,
            seed: torch.Tensor, counter: torch.Tensor, R: int,
            n: int) -> None:
    dev = seed.device
    S = seed.shape[0]
    cuda_lib.require(seed, "seed", dev, (torch.int64,), (S,))
    cuda_lib.require(counter, "counter", dev, (torch.int64,), (S,))
    if S == 0 or R % S:
        raise ValueError(f"{R} rows do not split over {S} slots")
    if R == 0 or n == 0:
        return
    rc = cuda_lib.lib().ps_sample(
        MODES[mode], cuda_lib.ptr(dist), out.data_ptr(), seed.data_ptr(),
        counter.data_ptr(), R, n, R // S, S, cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["sample"] += 1
    cuda_lib.check(rc, f"sample ({mode})")


def sample_categorical(dist: torch.Tensor, seed: torch.Tensor,
                       counter: torch.Tensor) -> torch.Tensor:
    """One draw per row of dist [R, V] (f32; normalized or not) from the
    rows' slots' streams -> int64 [R]."""
    if dist.device.type == "cpu":
        return categorical_reference(dist, seed, counter)
    R, V = dist.shape
    cuda_lib.require(dist, "dist", seed.device, (torch.float32,), (R, V))
    out = torch.empty(R, dtype=torch.int64, device=dist.device)
    _launch("categorical", dist, out, seed, counter, R, V)
    return out


def _noise(mode: str, seed: torch.Tensor, counter: torch.Tensor, R: int,
           n: int) -> torch.Tensor:
    if seed.device.type == "cpu":
        ref = uniform_reference if mode == "uniform" else gumbel_reference
        return ref(seed, counter, R, n)
    out = torch.empty(R, n, dtype=torch.float32, device=seed.device)
    _launch(mode, None, out, seed, counter, R, n)
    return out


def sample_uniform(seed: torch.Tensor, counter: torch.Tensor, R: int,
                   n: int) -> torch.Tensor:
    """[R, n] uniforms in [0, 1) from the rows' slots' streams."""
    return _noise("uniform", seed, counter, R, n)


def sample_gumbel(seed: torch.Tensor, counter: torch.Tensor, R: int,
                  n: int) -> torch.Tensor:
    """[R, n] Gumbel(0, 1) noise from the rows' slots' streams."""
    return _noise("gumbel", seed, counter, R, n)

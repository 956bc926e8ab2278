"""Forward GQA flash attention: the CUDA launcher and, beside it, its plain
version.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_gqa`` (body
``_kernel``): q ``[B, Sq, H, dh]`` against k/v ``[B, Sk, KV, dh]``, query
head ``h`` on KV head ``h // G`` (``G = H // KV``), causal or not, with the
online softmax over key blocks (running max ``m``, denominator ``l`` and
fp32 accumulator ``acc``, rescaled per block, normalised once at the end),
fp32 scores, masked scores at the finite ``NEG_INF`` and the output in q's
dtype.  The causal mask is ``q_pos >= k_pos`` from the start of the
sequence: right for prefill (``Sq == Sk``), not for decode.

:func:`flash_attention_gqa` is the entry point: CUDA tensors launch a
CUDA body (float or bf16, head dims up to 256; it raises if it cannot
launch, and never falls back), CPU tensors run
:func:`flash_attention_plain`.  :func:`select_body` names the body:

- ``"wgmma"`` (``csrc/flash_wgmma.cu``): TMA-fed, warp-specialised wgmma;
  bf16 at dh 64, 112 and 128 on 16-byte aligned bases, the model path;
  :func:`wgmma_packing` lays the query heads over its CTAs;
- ``"mma_sync"`` (``csrc/flash_attention.cu``, ``flash_mma_kernel``): bf16
  at dh 64 and 128 on aligned bases on ``mma.sync``, kept as the yardstick
  the wgmma body is timed against; only an explicit ``body="mma_sync"``
  runs it;
- ``"fp32_pipes"`` (``flash_kernel``): fp32, other head dims, unaligned
  bases; any input when named.

All take ``Sq % block_q == 0`` and, under ``causal``, ``Sk % block_k ==
0`` as the TPU kernel does (``ops.py`` pads).  Non-causal calls take any
``Sk``: the CUDA bodies give keys at or past ``Sk`` weight 0 and the plain
version's last key tile is the shorter remainder, so the model path hands
an encoder's or a cross-attention's keys over unpadded
(``ops.flash_attention_ragged``).  The blocks shape the plain version's
tiles, while the CUDA bodies pick their own.  :data:`LAUNCHES` counts kernel launches and
:data:`PATH_LAUNCHES` the body each of them ran.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEG_INF = -1e30

# the CUDA bodies, by their codes in flash_attention_launch
BODIES = {"fp32_pipes": 0, "mma_sync": 1, "wgmma": 2}
# CUDA kernel launches; the plain version does not count.
LAUNCHES = {"flash_attention": 0}
# the same launches by the body that ran
PATH_LAUNCHES = {"wgmma": 0, "mma_sync": 0, "fp32_pipes": 0}
# the bf16 head dims each tensor-core body takes (on 16-byte aligned bases)
TENSOR_CORE_DH = {"wgmma": (64, 112, 128), "mma_sync": (64, 128)}


def reset_launches() -> None:
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for key in counts:
            counts[key] = 0


def select_body(dtype, dh: int, aligned: bool, body=None) -> str:
    """The CUDA body for inputs of ``dtype`` at head dim ``dh`` whose bases
    are all 16-byte aligned (``aligned``): ``body`` if it can take them
    (else ``ValueError``), or by default ``"wgmma"`` for bf16 at dh 64, 112
    and 128 on aligned bases and ``"fp32_pipes"`` for everything else."""
    def takes(name):
        return (dtype == torch.bfloat16 and aligned
                and dh in TENSOR_CORE_DH[name])
    if body is None:
        return "wgmma" if takes("wgmma") else "fp32_pipes"
    if body not in BODIES:
        raise ValueError(f"unknown flash-attention body {body!r}; the "
                         f"bodies are {', '.join(BODIES)}")
    if body != "fp32_pipes" and not takes(body):
        *most, last = TENSOR_CORE_DH[body]
        raise ValueError(f"the {body} body takes bfloat16 at head dims "
                         f"{', '.join(map(str, most))} and {last} on 16-byte "
                         f"aligned bases, got {dtype} at dh {dh}"
                         f"{'' if aligned else ', unaligned'}")
    return body


# rows (position, head) of a wgmma-body CTA
WGMMA_ROWS = 128


class WgmmaPacking(NamedTuple):
    heads: int        # query heads of one KV head a CTA (GH)
    positions: int    # positions a CTA (BQ): heads x positions <= 128 rows
    chunks: int       # CTAs side by side for one position block (G // GH)


def wgmma_packing(G: int, heads=None) -> WgmmaPacking:
    """How the wgmma body lays a KV head's ``G`` query heads over its
    128-row CTAs: ``heads`` of them x ``128 // heads`` positions a CTA, the
    ``G // heads`` chunks side by side for one block of positions.  By
    default ``heads = gcd(G, 128)``, so all 128 rows are live (G 48: 16
    heads x 8 positions, 3 chunks; G 7: 1 x 128, 7 chunks; a G that divides
    128: all G heads, one chunk).  ``heads`` names another count: it must
    divide G and be at most 128, else ``ValueError`` (the C entry refuses
    it too)."""
    if heads is None:
        heads = math.gcd(G, WGMMA_ROWS)
    if not 1 <= heads <= WGMMA_ROWS or G % heads:
        raise ValueError(f"the wgmma body takes a divisor of G {G} up to "
                         f"{WGMMA_ROWS} as its heads a CTA, got {heads}")
    return WgmmaPacking(heads, WGMMA_ROWS // heads, G // heads)


def _check(q, k, v, block_q: int, block_k: int, causal: bool):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,Sq,H,dh] and k, v [B,Sk,KV,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    Bk, Sk, KV, dhk = k.shape
    if Bk != B or dhk != dh or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (batch, head dim, H % KV)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q "
                             f"{q.dtype} on {q.device}")
    if Sq % block_q or (causal and Sk % block_k):
        raise ValueError(f"Sq {Sq} and Sk {Sk} must be multiples of "
                         f"block_q {block_q} and block_k {block_k} (Sk "
                         f"only under causal; ops.flash_attention pads)")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_q: int = 512, block_k: int = 512):
    """Plain PyTorch version of the kernel (any device): the TPU kernel's
    blocked online softmax, one (q block, k block) tile at a time; a
    non-causal call's last key tile holds the ``Sk % block_k`` keys left."""
    _check(q, k, v, block_q, block_k, causal)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    # [B,S,H,dh] -> [B*KV, G, Sq, dh]; k/v -> [B*KV, Sk, dh]
    qr = (q.reshape(B, Sq, KV, G, dh).permute(0, 2, 3, 1, 4)
          .reshape(B * KV, G, Sq, dh))
    kr = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, dh)
    vr = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, dh)
    out = torch.empty((B * KV, G, Sq, dh), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, block_q):
        qb = qr[:, :, q0:q0 + block_q].float()            # [BK, G, bq, dh]
        m = torch.full((B * KV, G, block_q), NEG_INF, **f32)
        l = torch.zeros((B * KV, G, block_q), **f32)
        acc = torch.zeros((B * KV, G, block_q, dh), **f32)
        for k0 in range(0, Sk, block_k):
            kb = kr[:, None, k0:k0 + block_k].float()      # [BK, 1, bk, dh]
            vb = vr[:, None, k0:k0 + block_k]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                q_pos = q0 + torch.arange(block_q, device=dev)[:, None]
                k_pos = k0 + torch.arange(block_k, device=dev)[None, :]
                s = torch.where(q_pos >= k_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).float(), vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        denom = torch.clamp_min(l, 1e-30)[..., None]
        out[:, :, q0:q0 + block_q] = (acc / denom).to(q.dtype)
    return (out.reshape(B, KV, G, Sq, dh).permute(0, 3, 1, 2, 4)
            .reshape(B, Sq, H, dh))


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         block_q: int = 512, block_k: int = 512, body=None,
                         drop_key_tile=None):
    """Launch a CUDA body on the current stream (no synchronisation); same
    arguments and result as :func:`flash_attention_plain`.  ``body`` names
    the body (:func:`select_body`; ``None`` picks it).  ``drop_key_tile``
    (wgmma only) leaves that 128-key tile out: a planted fault for the
    control of the checks, ``None`` in every real call."""
    from repro_torch.kernels.flash_attention import build

    if any(type(t) is not torch.Tensor for t in (q, k, v)):
        raise TypeError(f"the CUDA kernel takes plain tensors, got "
                        f"{type(q).__name__}: launch it on each shard's "
                        f"local tensor")
    _check(q, k, v, block_q, block_k, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    if q.dtype not in dtypes:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if dh > 256:
        raise ValueError(f"the CUDA kernel takes head dims up to 256, got "
                         f"{dh}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, o))
    body = select_body(q.dtype, dh, aligned, body)
    if drop_key_tile is not None and body != "wgmma":
        raise ValueError(f"drop_key_tile is a fault of the wgmma body, not "
                         f"of {body}")
    lib = build.load()
    max_group = lib.flash_attention_max_group(BODIES[body], dh)
    if H // KV > max_group:
        raise ValueError(f"the {body} body takes at most {max_group} query "
                         f"heads per KV head at dh {dh}, got {H // KV}")
    heads = wgmma_packing(H // KV).heads if body == "wgmma" else 0
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Sk, H, KV, dh, dtypes[q.dtype], int(causal),
            1.0 / math.sqrt(dh), BODIES[body],
            -1 if drop_key_tile is None else int(drop_key_tile), heads,
            stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention launch ({body}) failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}"
                           f" ({rc})")
    LAUNCHES["flash_attention"] += 1
    PATH_LAUNCHES[body] += 1
    return o


def flash_attention_gqa(q, k, v, *, causal: bool = True, block_q: int = 512,
                        block_k: int = 512):
    """q [B, Sq, H, dh]; k/v [B, Sk, KV, dh]; H % KV == 0 -> o [B, Sq, H, dh].
    CUDA tensors run the CUDA kernel; CPU tensors the plain version."""
    fn = (flash_attention_cuda if q.device.type == "cuda"
          else flash_attention_plain)
    return fn(q, k, v, causal=causal, block_q=block_q, block_k=block_k)

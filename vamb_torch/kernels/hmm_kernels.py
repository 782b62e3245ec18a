"""The profile-HMM Forward kernel: wrapper, plain version, launch counter.

`hmm_forward(lom, t, tbm, codes, lengths)` replaces `vamb_tpu/ops/hmm.py`
`_forward_batch` (:229-288), a `lax.scan` over residues vmapped over genes
(not a Pallas kernel): HMMER3's multihit-local Forward bit scores of a
batch of encoded genes against one local profile. The CUDA C++ kernel for
sm_90a is `csrc/hmm_forward.cu`, whose note says what bounds it on the
H100 and what its design does about that: the recurrence in probabilities
scaled by exact powers of two (HMMER3's own scaled Forward), so a DP cell
is a dozen f32 operations and no transcendental; a group of ceil(M / 256)
warps a gene in persistent CTAs; the emission odds staged in shared memory
once a CTA; the delete chain as a shuffle scan of affine maps; at most one
named barrier a residue.

`hmm_forward_plain` is the same recurrence as a Python loop over residues,
vectorised over (genes, nodes) in torch, in JAX's formulation (the delete
chain as an inclusive prefix log-sum-exp of a - s, then + s). The wrapper
runs it for a CPU tensor and launches the kernel for a CUDA tensor; it
counts launches in `hmm_forward.launches`. The kernel sums probabilities
where the plain version adds logarithms, so its scores are not bit-equal
to the plain version's; the tests state the tolerance.
"""

import ctypes
import math
import threading
from pathlib import Path

import torch

from .cluster_kernels import build

_SOURCE = Path(__file__).resolve().parent / "csrc" / "hmm_forward.cu"
NULL_CODE = 20
_NEG = -1e30
_MAX_NODES = 2048  # kMaxNodes in the CUDA source

_lib = None
_lib_lock = threading.Lock()


def build_hmm(verbose: bool = False) -> Path:
    "Compile `csrc/hmm_forward.cu` with nvcc unless an up-to-date build exists."
    return build(verbose=verbose, source=_SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_hmm()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.vt_hmm_forward.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp]
            lib.vt_hmm_forward.restype = ci
            lib.vt_hmm_max_nodes.argtypes, lib.vt_hmm_max_nodes.restype = [], ci
            if lib.vt_hmm_max_nodes() != _MAX_NODES:
                raise RuntimeError(f"{_SOURCE.name} and {__name__} disagree on its constants")
            _lib = lib
    return _lib


def last_residues(codes: torch.Tensor) -> torch.Tensor:
    "(B,) int32: 1 + each gene's last non-null position (0 for none)."
    pos = torch.arange(1, codes.shape[1] + 1, dtype=torch.int32, device=codes.device)
    return torch.where(codes < NULL_CODE, pos, 0).amax(1).to(torch.int32)


def hmm_forward_plain(lom, t, tbm, codes, lengths) -> torch.Tensor:
    """Forward bit scores, the recurrence of `_forward_batch` in torch.

    lom (M, 21) f32 (the 20 match log-odds and a zero column), t (M+1, 7)
    f32 clamped at -1e30, tbm (M,) f32 clamped likewise, codes (B, L)
    int8 (20 = null residue), lengths (B,) f32 -> (B,) f32 bits."""
    m = lom.shape[0]
    b_count = codes.shape[0]
    dev = lom.device
    tmm, tmi, tmd = t[1:-1, 0], t[1:, 1], t[1:-1, 2]
    tim, tii, tdm = t[1:, 3], t[1:, 4], t[1:-1, 5]
    s = torch.cat([t.new_zeros(1), torch.cumsum(t[1:-1, 6], 0)])  # the delete chain's offsets
    L = lengths.to(torch.float32)
    loop = torch.log(L / (L + 3.0))
    move = torch.log(3.0 / (L + 3.0))
    tej = math.log(0.5)
    null1 = L * torch.log(L / (L + 1.0)) - torch.log(L + 1.0)
    neg = torch.full((b_count, 1), _NEG, dtype=torch.float32, device=dev)
    mrow = torch.full((b_count, m), _NEG, dtype=torch.float32, device=dev)
    irow, drow = mrow.clone(), mrow.clone()
    n = torch.zeros(b_count, dtype=torch.float32, device=dev)
    b, j, c = move.clone(), neg[:, 0].clone(), neg[:, 0].clone()
    lomT = lom.T.contiguous()
    last = int(last_residues(codes).max()) if b_count else 0
    for pos in range(last):
        x = codes[:, pos].long()
        emit = lomT[x]  # (B, M)
        prev_m = torch.cat([neg, mrow[:, :-1] + tmm], 1)
        prev_i = torch.cat([neg, irow[:, :-1] + tim[:-1]], 1)
        prev_d = torch.cat([neg, drow[:, :-1] + tdm], 1)
        m_new = emit + torch.logaddexp(torch.logaddexp(prev_m, prev_i),
                                       torch.logaddexp(prev_d, b[:, None] + tbm))
        i_new = torch.logaddexp(mrow + tmi, irow + tii)
        a = torch.cat([neg, m_new[:, :-1] + tmd], 1)
        d_new = torch.logcumsumexp(a - s, 1) + s
        e = torch.logsumexp(m_new, 1)
        n_new = n + loop
        j_new = torch.logaddexp(j + loop, e + tej)
        c_new = torch.logaddexp(c + loop, e + tej)
        b_new = torch.logaddexp(n_new + move, j_new + move)
        pad = x >= NULL_CODE
        mrow = torch.where(pad[:, None], mrow, m_new)
        irow = torch.where(pad[:, None], irow, i_new)
        drow = torch.where(pad[:, None], drow, d_new)
        n, b = torch.where(pad, n, n_new), torch.where(pad, b, b_new)
        j, c = torch.where(pad, j, j_new), torch.where(pad, c, c_new)
    return (c + move - null1) / math.log(2.0)


def hmm_forward(lom, t, tbm, codes, lengths, nres=None) -> torch.Tensor:
    """Forward bit scores of B genes against one local profile (see
    `hmm_forward_plain` for the shapes). For CUDA tensors it launches the
    kernel (counted in `hmm_forward.launches`), with `nres` (B,) int32, 1 +
    each gene's last non-null position, computed when not given; for CPU
    tensors it runs the plain version."""
    if lom.dim() != 2 or lom.shape[1] != NULL_CODE + 1:
        raise ValueError("lom must be (M, 21): the match log-odds and a zero column")
    m = lom.shape[0]
    if t.shape != (m + 1, 7) or tbm.shape != (m,):
        raise ValueError(f"t must be ({m + 1}, 7) and tbm ({m},) for M = {m}")
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError("codes must be a (B, L) int8 tensor")
    if lengths.shape != (codes.shape[0],):
        raise ValueError("lengths must be (B,)")
    if any(v.dtype != torch.float32 for v in (lom, t, tbm, lengths)):
        raise ValueError("lom, t, tbm and lengths must be float32")
    dev = lom.device
    if any(v.device != dev for v in (t, tbm, codes, lengths)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return hmm_forward_plain(lom, t, tbm, codes, lengths)
    if dev.type != "cuda":
        raise ValueError(f"hmm_forward runs on cuda or cpu, not {dev}")
    if not 1 <= m <= _MAX_NODES:
        raise ValueError(f"the kernel takes 1 to {_MAX_NODES} nodes, not {m}")
    b_count, L = codes.shape
    out = torch.empty(b_count, dtype=torch.float32, device=dev)
    if b_count == 0:
        return out
    if nres is None:
        nres = last_residues(codes)
    if nres.shape != (b_count,) or nres.dtype != torch.int32 or nres.device != dev:
        raise ValueError("nres must be a (B,) int32 tensor on the inputs' device")
    if not all(v.is_contiguous() for v in (t, tbm, codes, lengths, nres)):
        raise ValueError("t, tbm, codes, lengths and nres must be contiguous")
    lib = _load()
    lomT = lom.T.contiguous()  # (21, M): a residue's emissions side by side
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vt_hmm_forward(lomT.data_ptr(), t.data_ptr(), tbm.data_ptr(), codes.data_ptr(),
                             lengths.data_ptr(), nres.data_ptr(), m, b_count, L, out.data_ptr(),
                             stream)
    if err != 0:
        raise RuntimeError(f"hmm_forward kernel launch failed with cudaError {err}")
    hmm_forward.launches += 1
    return out


hmm_forward.launches = 0

"""The training kernels' wrappers, each beside its plain torch version and
with a launch count: ``adamw_update`` (one AdamW step over a leaf or a
ZeRO-1 block, with the global-norm clip's scale folded in) and the radix
select's ``radix_hist`` and ``radix_pick`` (one round's histogram of a
digit of ``|x|``'s bit pattern, and the round's choice of digit), which
``radix_select`` runs round by round.

Each wrapper first refuses what its kernel does not take (a dtype, a
shape, a non-contiguous view, operands on several devices), on every
device, so the CPU and the card hold one contract.  Given CPU (or ``meta``)
tensors it then returns its plain version's result.  Given CUDA tensors it
launches the hand-written kernel
(``csrc/train.cu``, built by ``repro_torch.kernels.build.train_library``)
on the current stream, without synchronising, or raises: there is no
fallback.  Neither function is a Pallas kernel in the JAX package: the
reference's AdamW is jnp (``repro.training.optimizer``, optimizer.py:63-93)
and its top-k threshold ``jax.lax.top_k`` (``repro.training.compression``,
compression.py:39-45).

``launches[kind]`` grows by one at each kernel launch and nowhere else
(plain-version calls do not count); ``reset_launches()`` sets them to 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

KINDS = ("adamw_update", "radix_hist", "radix_pick")
launches = dict.fromkeys(KINDS, 0)

#: the most elements of one leaf that one slice of the plain AdamW update
#: holds: its float32 temporaries stay a few slices however large a leaf
#: is (a full-width MoE layer's experts are one leaf of 0.8 G elements);
#: the update is elementwise, so slicing changes no number
SLICE = 1 << 26

#: the most elements one chunk of the plain histogram reads, for the same
#: reason
HIST_CHUNK = 1 << 24

#: the select's rounds: (shift, width) of each digit of the magnitudes'
#: bit patterns, high digit first (bit 31 is the sign, 0)
RADIX_ROUNDS = ((21, 11), (10, 11), (0, 10))

_ADAMW_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    launches.update(dict.fromkeys(KINDS, 0))


def flat_slices(*tensors: torch.Tensor, size: int | None = None):
    """Yield matching flat slices (views) of same-shaped contiguous
    tensors, ``size`` elements at a time (``SLICE`` unless given)."""
    size = SLICE if size is None else size
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for lo in range(0, n, size):
        yield tuple(f[lo:lo + size] for f in flat)


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for operands on one CUDA device (the kernel); False for CPU or
    ``meta`` ones (the plain version); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type in ("cpu", "meta"):
        return False
    if device.type != "cuda":
        raise ValueError(f"the training kernels run on CUDA devices, got {device}")
    return True


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: cuda error {rc}")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_update_plain(g, m, v, ref, p, lr, c1, c2, lr_wd, scale=None, *, b1: float,
                       b2: float, eps: float) -> None:
    """One AdamW step over one leaf, in place, in flat slices of ``SLICE``
    elements.  ``ref`` is the float32 master weight, or ``None`` without
    master weights (then ``p`` itself, read as float32, is the reference).
    With ``scale`` (the clip's) the gradient is first ``to_dtype(g *
    scale)``, as the clip would have written it.  Every division divides
    by a tensor (a division by a Python scalar is a multiplication by its
    reciprocal, which rounds twice)."""
    pieces = (g, m, v, p) if ref is None else (g, m, v, p, ref)
    for sl in flat_slices(*pieces):
        g_s, m_s, v_s, p_s = sl[:4]
        r_s = p_s.float() if ref is None else sl[4]
        g_s = g_s.float()
        if scale is not None:
            g_s = (g_s * scale).to(g.dtype).float()
        m_s.mul_(b1).add_(g_s * (1 - b1))
        v_s.mul_(b2).add_(g_s.square().mul_(1 - b2))
        u = (m_s / c1).mul_(lr).div_((v_s / c2).sqrt_().add_(eps))
        decay = r_s * lr_wd
        r_s.sub_(u).sub_(decay)
        p_s.copy_(r_s)


def adamw_update(g, m, v, ref, p, lr, c1, c2, lr_wd, scale=None, *, b1: float, b2: float,
                 eps: float) -> None:
    """``adamw_update_plain``'s step in one launch on the card: reads ``g``
    (bf16 or float32), ``m``, ``v`` and the reference, writes ``m``, ``v``,
    ``ref`` and ``p`` (bf16 or float32), bit for bit the plain version's.
    ``lr``, ``c1``, ``c2``, ``lr_wd`` and ``scale`` are one-element float32
    tensors on the card, read there; ``b1``, ``1 - b1``, ``b2``, ``1 - b2``
    and ``eps`` are passed as float32, each rounded from the Python float
    as torch rounds a scalar operand.  Every tensor operand is contiguous
    and of ``p``'s shape."""
    tensors = [t for t in (g, m, v, ref, p) if t is not None]
    scalars = [t for t in (lr, c1, c2, lr_wd, scale) if t is not None]
    card = _on_card(*tensors, *scalars)
    _require(g.dtype in _ADAMW_DTYPES and p.dtype in _ADAMW_DTYPES,
             f"adamw_update takes bf16 or float32 gradients and parameters, got {g.dtype} "
             f"and {p.dtype}")
    _require(all(t.dtype == torch.float32 for t in (m, v) + (() if ref is None else (ref,))),
             "adamw_update keeps m, v and the master weight in float32")
    _require(all(t.shape == p.shape for t in tensors),
             f"adamw_update's operands must share the parameter's shape {tuple(p.shape)}, got "
             f"{[tuple(t.shape) for t in tensors]}")
    _require(all(t.is_contiguous() for t in tensors),
             "adamw_update's operands must be contiguous")
    _require(all(t.dtype == torch.float32 and t.numel() == 1 for t in scalars),
             "adamw_update's lr, c1, c2, lr_wd and scale are one-element float32 tensors")
    if not card:
        return adamw_update_plain(g, m, v, ref, p, lr, c1, c2, lr_wd, scale, b1=b1, b2=b2,
                                  eps=eps)
    if p.numel():
        with torch.cuda.device(p.device):
            rc = build.train_library().train_adamw_update(
                int(g.dtype == torch.bfloat16), int(p.dtype == torch.bfloat16), _ptr(g), _ptr(m),
                _ptr(v), _ptr(ref), _ptr(p), _ptr(lr), _ptr(c1), _ptr(c2), _ptr(lr_wd),
                _ptr(scale), b1, 1 - b1, b2, 1 - b2, eps, p.numel(), _stream(p))
        _check(rc, "adamw_update")
        launches["adamw_update"] += 1
    return None


# ---------------------------------------------------------------------------
# the radix select
# ---------------------------------------------------------------------------


def radix_hist_plain(flat, prefix, shift: int, width: int) -> torch.Tensor:
    """One round's histogram: int64 counts of the digit ``(|x| >> shift) &
    (2^width - 1)`` over the elements of ``flat`` (float32) whose bits above
    the digit match ``prefix``'s (a ``(1,)`` int32 tensor), ``|x|``'s bit
    pattern read as int32.  ``torch.histc`` over the digits as floats with
    unit bins (exact: a digit and a count per chunk stay below 2^24), which
    never waits for the device (``torch.bincount`` reads its input's range
    on the host); ``HIST_CHUNK`` elements at a time."""
    bins = 1 << width
    top = shift + width  # the bits above this digit are known
    hist = torch.zeros(bins, dtype=torch.int64, device=flat.device)
    for lo in range(0, flat.numel(), HIST_CHUNK):
        bits = flat[lo:lo + HIST_CHUNK].abs().view(torch.int32)
        digit = (bits >> shift) & (bins - 1)
        if top < 32:  # an element off the prefix falls outside the range
            digit = torch.where((bits >> top) == (prefix >> top), digit, -1)
        hist += torch.histc(digit.float(), bins, -0.5, bins - 0.5).long()
    return hist


def _check_round(shift: int, width: int) -> None:
    _require(1 <= width <= 11 and shift >= 0 and shift + width <= 32,
             f"a digit of 1-11 bits within 32, got shift {shift}, width {width}")


def radix_hist(flat, prefix, shift: int, width: int) -> torch.Tensor:
    """``radix_hist_plain`` in one launch on the card (into a zeroed
    ``(2^width,)`` int64 tensor it returns); ``flat`` is a contiguous 1-D
    float32 tensor, ``prefix`` one int32 on the card."""
    card = _on_card(flat, prefix)
    _check_round(shift, width)
    _require(flat.dtype == torch.float32 and flat.dim() == 1 and flat.is_contiguous(),
             f"radix_hist takes a contiguous 1-D float32 tensor, got {flat.dtype} of shape "
             f"{tuple(flat.shape)} (contiguous={flat.is_contiguous()})")
    _require(prefix.dtype == torch.int32 and prefix.numel() == 1,
             "radix_hist's prefix is one int32")
    if not card:
        return radix_hist_plain(flat, prefix, shift, width)
    hist = torch.zeros(1 << width, dtype=torch.int64, device=flat.device)
    if flat.numel():
        with torch.cuda.device(flat.device):
            rc = build.train_library().train_radix_hist(
                _ptr(flat), flat.numel(), shift, width, _ptr(prefix), _ptr(hist), _stream(flat))
        _check(rc, "radix_hist")
        launches["radix_hist"] += 1
    return hist


def radix_pick_plain(hist, sought, prefix, shift: int) -> None:
    """One round's choice, in place: the highest digit ``d`` whose count
    from the top (the elements at or above it) reaches ``sought`` (a
    ``(1,)`` int64 tensor, the rank still sought); the elements strictly
    above ``d`` leave ``sought`` and ``d << shift`` joins ``prefix``.  The
    digit is indexed on the device (``index_select``): nothing is read back
    to the host."""
    from_top = hist.flip(0).cumsum(0).flip(0)  # elements at or above each digit
    d = (from_top >= sought).sum().view(1) - 1  # the highest digit whose count reaches it
    sought.sub_(from_top.index_select(0, d) - hist.index_select(0, d))
    prefix.bitwise_or_(d.to(torch.int32) << shift)


def radix_pick(hist, sought, prefix, shift: int) -> None:
    """``radix_pick_plain`` in one launch of one block on the card;
    ``hist`` is a contiguous ``(2^width,)`` int64 tensor, width 1-11."""
    card = _on_card(hist, sought, prefix)
    width = hist.numel().bit_length() - 1
    _check_round(shift, width)
    _require(hist.dtype == torch.int64 and hist.dim() == 1 and hist.numel() == 1 << width
             and hist.is_contiguous(),
             f"radix_pick takes a contiguous (2^width,) int64 histogram, got {hist.dtype} of "
             f"shape {tuple(hist.shape)}")
    _require(sought.dtype == torch.int64 and sought.numel() == 1
             and prefix.dtype == torch.int32 and prefix.numel() == 1,
             "radix_pick's sought is one int64 and its prefix one int32")
    if not card:
        return radix_pick_plain(hist, sought, prefix, shift)
    with torch.cuda.device(hist.device):
        rc = build.train_library().train_radix_pick(
            _ptr(hist), shift, width, _ptr(sought), _ptr(prefix), _stream(hist))
    _check(rc, "radix_pick")
    launches["radix_pick"] += 1
    return None


def _select(gf, k: int, reduce, hist_fn, pick_fn) -> torch.Tensor:
    flat = gf.reshape(-1)
    # (1,) tensors made on the device: a scalar copied from the host or an
    # index read back would wait for the device
    prefix = torch.zeros(1, dtype=torch.int32, device=flat.device)
    sought = torch.full((1,), k, dtype=torch.int64, device=flat.device)
    for shift, width in RADIX_ROUNDS:
        hist = hist_fn(flat, prefix, shift, width)
        if reduce is not None:
            hist = reduce(hist)
        pick_fn(hist, sought, prefix, shift)
    return prefix.view(torch.float32)[0]


def radix_select(gf, k: int, reduce=None) -> torch.Tensor:
    """The k-th largest ``|x|`` of ``gf`` (float32), counted with
    multiplicity, as a float32 0-dim tensor: the three rounds of
    ``RADIX_ROUNDS``, each a ``radix_hist`` launch, ``reduce`` of its
    histogram (the sum over the mesh axes that cut the leaf, where ``gf``
    is one block of it) and a ``radix_pick`` launch.  Non-negative float32
    values order as their bit patterns do, so the prefix of the three
    digits, read as float32, is the value, equal bit for bit to
    ``torch.topk(|x|, k).values[-1]`` (a NaN orders above inf, ``-0.0`` has
    the magnitude 0); nothing waits for the host."""
    return _select(gf, k, reduce, radix_hist, radix_pick)


def radix_select_plain(gf, k: int, reduce=None) -> torch.Tensor:
    """``radix_select`` through the plain versions, on any device."""
    return _select(gf, k, reduce, radix_hist_plain, radix_pick_plain)

"""Red/black checkerboard layout: the active color as a dense [H, W/2] grid.

Counterpart of ``gipuma_tpu/ops/checkerboard.py`` with the same layout, so
engine tensors compare one to one with the JAX package's:

  * BLACK pixels satisfy (x + y) % 2 == 0, RED (x + y) % 2 == 1;
  * parity p in {0 (black), 1 (red)}; active x(y, j) = 2*j + ((y + p) % 2);
  * W must be even (the pipeline pads odd-width images).
"""
from __future__ import annotations

import torch


def row_parity(h: int, parity: int, device="cpu") -> torch.Tensor:
    """[H, 1] int32 tensor: (y + parity) % 2 — the active-x offset per row."""
    y = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    return (y + parity) % 2


def active_x(h: int, w2: int, parity: int, dtype=torch.float32,
             device="cpu") -> torch.Tensor:
    """[H, W2] x-coordinates of the active pixels."""
    j = torch.arange(w2, dtype=torch.int32, device=device)[None, :]
    return (2 * j + row_parity(h, parity, device)).to(dtype)


def active_y(h: int, w2: int, dtype=torch.float32, device="cpu"
             ) -> torch.Tensor:
    """[H, W2] y-coordinates (the row index broadcast)."""
    return torch.arange(h, device=device).to(dtype)[:, None].expand(h, w2)


def _rp(a: torch.Tensor, parity: int) -> torch.Tensor:
    rp = row_parity(a.shape[0], parity, a.device)
    return rp[..., None] if a.ndim == 3 else rp


def extract(a: torch.Tensor, parity: int) -> torch.Tensor:
    """Compress a full [H, W(, C)] tensor to the active half-grid."""
    return torch.where(_rp(a, parity) == 0, a[:, 0::2], a[:, 1::2])


def interleave(a: torch.Tensor, vals: torch.Tensor, parity: int
               ) -> torch.Tensor:
    """Scatter half-grid `vals` [H, W2(, C)] back into a copy of the full
    tensor `a`, writing only the active color's pixels."""
    rp = _rp(a, parity)
    new_e = torch.where(rp == 0, vals, a[:, 0::2])
    new_o = torch.where(rp == 1, vals, a[:, 1::2])
    return torch.stack([new_e, new_o], dim=2).reshape(a.shape)


class PaddedEO:
    """Even/odd column split of an edge-padded [H + 2*pr, W + 2*pc(, C)]
    tensor, for neighbor reads at static offsets (`shifted`)."""

    def __init__(self, E, O, pr: int, pc: int, h: int, w2: int):
        self.E, self.O = E, O
        self.pr, self.pc, self.h, self.w2 = pr, pc, h, w2
        self._windows: dict = {}
        self._planes = None
        self._fits: set = set()

    @staticmethod
    def build(a: torch.Tensor, pr: int, pc: int) -> "PaddedEO":
        """Edge-pad `a` ([H, W] or [H, W, C]) and split columns even/odd.
        Edge padding replicates border pixels (the reference's clamp)."""
        if pc % 2:
            pc += 1
        h, w = a.shape[:2]
        assert w % 2 == 0, "width must be even"
        ri = torch.arange(-pr, h + pr, device=a.device).clamp(0, h - 1)
        ci = torch.arange(-pc, w + pc, device=a.device).clamp(0, w - 1)
        ap = a[ri][:, ci]
        return PaddedEO(E=ap[:, 0::2], O=ap[:, 1::2], pr=pr, pc=pc, h=h,
                        w2=w // 2)

    @staticmethod
    def build_row_padded(a_ext: torch.Tensor, pr: int, pc: int
                         ) -> "PaddedEO":
        """Like `build`, but `a_ext` already carries pr real halo rows on
        each side (tile sharding, parallel/tiled.py); only the columns are
        edge-padded."""
        if pc % 2:
            pc += 1
        h_ext, w = a_ext.shape[:2]
        assert w % 2 == 0, "width must be even"
        ci = torch.arange(-pc, w + pc, device=a_ext.device).clamp(0, w - 1)
        ap = a_ext[:, ci]
        return PaddedEO(E=ap[:, 0::2], O=ap[:, 1::2], pr=pr, pc=pc,
                        h=h_ext - 2 * pr, w2=w // 2)

    def shifted(self, dy: int, dx: int, parity: int) -> torch.Tensor:
        """[H, W2(, C)] values at (y + dy, x + dx) for all active pixels
        (y, x) of `parity`; out-of-image reads are edge-replicated."""
        def plane(pi: int) -> torch.Tensor:
            s = pi + dx + self.pc
            src = self.E if s % 2 == 0 else self.O
            r0, c0 = self.pr + dy, s // 2
            return src[r0:r0 + self.h, c0:c0 + self.w2]

        b0, b1 = plane(0), plane(1)
        return torch.where(_rp(b0, parity) == 0, b0, b1)

    def windows(self, offsets, parity: int) -> torch.Tensor:
        """[O, H, W2(, C)]: ``shifted(dy, dx, parity)`` for each (dx, dy)
        of `offsets`, stacked.  Kept per (offsets, parity): the exact cost
        reads the same reference windows in every evaluation of a run
        (the JAX package re-slices them inside its offset scan)."""
        key = (tuple(offsets), int(parity))
        win = self._windows.get(key)
        if win is None:
            win = torch.stack([self.shifted(dy, dx, parity)
                               for dx, dy in offsets])
            self._windows[key] = win
        return win

    def planes(self, offsets) -> torch.Tensor:
        """[2, H + 2pr, W2 + pc(, C)]: E and O stacked, contiguous, for
        reads at `offsets` (the exact cost's window-sum kernel); made once,
        like the windows.  Each offset must fit the padding (|dx| <= pc,
        |dy| <= pr), as `shifted` needs: checked once per `offsets`."""
        key = tuple(offsets)
        if key not in self._fits:
            if any(abs(dx) > self.pc or abs(dy) > self.pr for dx, dy in key):
                raise ValueError(f"the window exceeds the reference padding "
                                 f"(pr {self.pr}, pc {self.pc})")
            self._fits.add(key)
        if self._planes is None:
            self._planes = torch.stack([self.E, self.O]).contiguous()
        return self._planes

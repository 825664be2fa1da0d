"""Binned histograms of masked numeric columns (kernel ``csrc/histogram.cu``,
replacing ``binned_histograms_pallas``) and their plain PyTorch version."""

from __future__ import annotations

import torch

from anovos_tpu_torch.ops import kernels
from anovos_tpu_torch.ops.kernels import build

# above 32 bins shared memory holds the cutoffs and one int32 histogram per
# warp (36 KB at 1024 bins, inside the 48 KB a block gets without opting in)
MAX_BINS = 1024


def binned_histograms_plain(Xc: torch.Tensor, Mc: torch.Tensor, cutoffs: torch.Tensor,
                            nbins: int) -> torch.Tensor:
    """(k, rows) values and mask, (k, nbins-1) interior cutoffs → (k, nbins)
    f32 counts of the valid values.  The bin is the number of cutoffs
    strictly below the value, compared in f32."""
    k = Xc.shape[0]
    x = Xc.to(torch.float32)
    cuts = cutoffs.to(device=x.device, dtype=torch.float32)
    bins = (x[:, :, None] > cuts[:, None, :]).sum(dim=2)
    flat = bins + torch.arange(k, device=x.device)[:, None] * nbins
    counts = torch.bincount(flat[Mc], minlength=k * nbins)
    return counts.view(k, nbins).to(torch.float32)


def binned_histograms_cols(Xc: torch.Tensor, Mc: torch.Tensor, cutoffs: torch.Tensor,
                           nbins: int) -> torch.Tensor:
    """Kernel wrapper: Xc (k, rows) f32 and Mc (k, rows) bool, both
    contiguous, cutoffs (k, nbins-1) f32 → (k, nbins) f32 counts."""
    if Xc.dim() != 2 or Mc.shape != Xc.shape:
        raise ValueError(f"binned_histograms: X {tuple(Xc.shape)} and M {tuple(Mc.shape)} "
                         "must be the same (k, rows) shape")
    k = Xc.shape[0]
    if cutoffs.shape != (k, nbins - 1):
        raise ValueError(f"binned_histograms: cutoffs {tuple(cutoffs.shape)} != ({k}, {nbins - 1})")
    if Xc.device.type == "cpu":
        return binned_histograms_plain(Xc, Mc, cutoffs, nbins)
    if Xc.device.type != "cuda":
        raise ValueError(f"binned_histograms: unsupported device {Xc.device}")
    if Xc.dtype != torch.float32 or Mc.dtype != torch.bool or cutoffs.dtype != torch.float32:
        raise TypeError("binned_histograms: X and cutoffs must be float32, M bool; got "
                        f"{Xc.dtype}, {Mc.dtype}, {cutoffs.dtype}")
    if not (Xc.is_contiguous() and Mc.is_contiguous() and cutoffs.is_contiguous()):
        raise ValueError("binned_histograms: X, M and cutoffs must be contiguous")
    if Mc.device != Xc.device or cutoffs.device != Xc.device:
        raise ValueError("binned_histograms: X, M and cutoffs must be on one device")
    if not 1 <= nbins <= MAX_BINS or k > build.C_INT_MAX:
        raise ValueError(f"binned_histograms: need 1 <= nbins <= {MAX_BINS} and "
                         f"k <= {build.C_INT_MAX}")
    out = torch.empty((k, nbins), dtype=torch.float32, device=Xc.device)
    if k == 0:
        return out
    Xc, Mc = build.aligned(Xc), build.aligned(Mc)
    # (k, nbins) int32 counts, then (k,) tickets; zeroed by the entry point
    scratch = torch.empty(k * nbins + k, dtype=torch.int32, device=Xc.device)
    lib = build.load()["histogram"]
    build.check(lib.anovos_histograms(Xc.data_ptr(), Mc.data_ptr(), cutoffs.data_ptr(),
                                      scratch.data_ptr(), out.data_ptr(), Xc.shape[1], k, nbins,
                                      Xc.device.index, build.stream_of(Xc)),
                "binned_histograms")
    kernels.count_launch("binned_histograms")
    return out

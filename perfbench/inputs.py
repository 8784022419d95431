"""Batches drawn from the seed on the device, in a few large calls.

A batch holds what the train step and the synthesis entry take, NCDHW:
  mri          [B, 1, S, S, S] float32, uniform in [0, 1) inside a ball
               (the brain) and 0 outside, so the modulator's brain mask
               cuts at its edge
  tau          [B, 1, S, S, S] float32, uniform in [0, 2) inside the ball
  roi_compact  [B, S, S, S]    int32 ROI ids, 0 outside the ball, 0..R in it
  covars       [B, 6]          [abeta in {0, 1}, age, sex, edu, cog,
                               meta_tau]; the last five standard normal
  roi_loc      [B, R]          uniform in [0.5, 2.0)
  roi_std      [B, R]          uniform in [0, 0.5)
Every seed gives the same sizes; only the values differ.
"""

from __future__ import annotations

from typing import Dict, List

import torch

NUM_COVARS = 6


def make_pool(seed: int, count: int, batch: int, size: int, rois: int,
              device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """`count` batches of the `seed` (the weights draw from a generator of
    their own), the same on every call with the same arguments."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED_BA7C)
    n = count * batch
    shape = (n, 1, size, size, size)
    axis = torch.arange(size, device=device, dtype=torch.float32)
    axis = (axis - (size - 1) / 2.0) / (size / 2.0)
    r2 = axis[:, None, None] ** 2 + axis[None, :, None] ** 2 + axis[None, None, :] ** 2
    brain = (r2 <= 0.8).float()
    vols = torch.rand((2,) + shape, generator=gen, device=device) * brain
    mri, tau = vols[0], vols[1] * 2.0
    ids = torch.randint(0, rois + 1, (n, size, size, size), generator=gen,
                        device=device, dtype=torch.int32)
    ids = ids * brain.to(torch.int32)
    covars = torch.randn((n, NUM_COVARS), generator=gen, device=device)
    covars[:, 0] = (torch.rand((n,), generator=gen, device=device) < 0.5).float()
    tables = torch.rand((2, n, rois), generator=gen, device=device)
    roi_loc, roi_std = 0.5 + 1.5 * tables[0], 0.5 * tables[1]
    pool = []
    for i in range(count):
        rows = slice(i * batch, (i + 1) * batch)
        pool.append({"mri": mri[rows], "tau": tau[rows],
                     "roi_compact": ids[rows], "covars": covars[rows],
                     "roi_loc": roi_loc[rows], "roi_std": roi_std[rows]})
    return pool

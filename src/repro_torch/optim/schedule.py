"""LR schedules, counterparts of the reference's ``optim/schedule.py``."""
import math

import torch


def warmup_cosine(step, *, base_lr, warmup_steps, total_steps, min_frac=0.1):
    """Linear warmup to ``base_lr``, then a cosine down to
    ``min_frac * base_lr`` at ``total_steps``.  ``step``: an int or a
    tensor; returns an f32 tensor on its device."""
    step = (step.float() if torch.is_tensor(step)
            else torch.tensor(float(step), dtype=torch.float32))
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)

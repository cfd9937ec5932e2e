from repro_torch.optim.adamw import Q8, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import warmup_cosine

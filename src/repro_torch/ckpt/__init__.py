from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step, load, save

from repro_torch.train.losses import lm_loss, lm_loss_from_hidden
from repro_torch.train.trainer import Trainer, make_train_step

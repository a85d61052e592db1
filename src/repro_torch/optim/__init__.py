"""Adam, FIXAR's fixed-point Adam and LR schedules (port of `repro.optim`)."""

from repro_torch.optim import adam, fxp_adam, schedule
from repro_torch.optim.adam import AdamConfig, AdamState, clip_by_global_norm, global_norm
from repro_torch.optim.fxp_adam import FxpAdamConfig

"""Optimizers, schedules and gradient compression (port of ``repro.optim``)."""

from repro_torch.optim import grad_compress, schedules
from repro_torch.optim.optimizers import (adam_init, adam_update,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, sgdm_init,
                                          sgdm_update)

"""Training: diffusion losses, the Adan optimizer, LR schedules, the train
step and EMA.

Counterpart of ``complex_prompt_diffusion_tpu/train``, with the same names:
``p_losses`` (eps / x0 / v targets, loss_simple + elbo weighting), ``adan``
(``init`` / ``update`` over parameter trees), the three LR lambda
schedulers, ``make_train_step`` and ``ema_update`` (``loop.LitEma`` and
``loop.ema_scope`` beside them). The step's gradients go through the
kernels' backward rules (``_build.kernel_with_plain_vjp``).
"""

from complex_prompt_diffusion_tpu_torch.train.loop import ema_update, make_train_step, p_losses
from complex_prompt_diffusion_tpu_torch.train.optimizers import adan
from complex_prompt_diffusion_tpu_torch.train.schedulers import (
    LambdaLinearScheduler,
    LambdaWarmUpCosineScheduler,
    LambdaWarmUpCosineScheduler2,
)

__all__ = [
    "adan",
    "LambdaWarmUpCosineScheduler",
    "LambdaWarmUpCosineScheduler2",
    "LambdaLinearScheduler",
    "p_losses",
    "make_train_step",
    "ema_update",
]

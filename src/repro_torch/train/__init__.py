from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.step import make_eval_step, make_train_step

__all__ = ["OptConfig", "opt_init", "opt_update", "make_train_step",
           "make_eval_step"]

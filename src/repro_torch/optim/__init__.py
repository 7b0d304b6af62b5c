from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.optim.schedule import make_schedule

from .compression import EFQ, ef_decode, ef_encode, ring_allreduce_q8
from .train_step import TrainState, init_train_state, loss_fn, train_step
from .trainer import Trainer, TrainerConfig

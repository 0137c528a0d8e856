from .adamw import (AdamWConfig, OptState, QTensor, apply_update, cosine_lr,
                    global_norm, init_opt_state)

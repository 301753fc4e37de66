# Shared base config. Every experiment config inherits from this via
# `_base_ = "default.py"`; child values always win (see parser.py).

random_seed = 42
learning_rate = 1e-3

# --- optimizer / schedule ---
adam_weight_decay = 0.01
adam_betas = (0.9, 0.999)
warmup_steps = 0              # linear warmup before cosine decay
grad_clip_norm = None         # optional global-norm clipping

# --- precision / compute ---
compute_dtype = "bfloat16"    # activations dtype inside the step
param_dtype = "float32"       # master params stay f32
use_pallas = False            # read by the JAX package only

# --- data / infra ---
data_dir = "data"             # where MNIST/CIFAR files live; synthetic fallback if absent
num_workers = 0               # host-side loader threads (native loader if >0)
prefetch_depth = 2            # device prefetch double-buffering depth
mesh_shape = None             # None = 1D data mesh over all local devices
log_every = 50                # steps between metric writes
checkpoint_dir = "runs"       # checkpoint root
keep_checkpoints = 3

# --- distillation (off by default) ---
use_distillation = False
distill_temperature = 2.0     # T=2
distill_alpha = 0.25          # KD weight; CE weight = 1 - alpha

# --- model fallbacks (overridden per experiment) ---
val_batch_size = 512
dropout = 0.1
activation = "gelu"
method = "permut_mix"         # mixer: permut_mix|fft_bare|fft_mh|dwt_embed|dwt_token|attention
mix_impl = "folded"           # permut-mix impl: "folded" (exact reference
                              # semantics, signs/pool folded into per-token
                              # projection weights; DEFAULT) | "gather" |
                              # "structured" | "gather_tm" | "gather_unfused"

# SpectreViT on CIFAR-100, the flagship config (the same values as the JAX
# package's spectre_tpu/configs/spectre_vit_cifar100.py).
_base_ = "default.py"

model = "spectre_vit"
method = "permut_mix"
dataset = "cifar100"

batch_size = 256
val_batch_size = 512
epochs = 100
num_classes = 100
patch_size = 4
img_size = 32
in_channels = 3
num_heads = 16
dropout = 0.001
hidden_dim = 768
adam_weight_decay = 0.01
adam_betas = (0.9, 0.999)
activation = "gelu"
num_encoders = 4
embed_dim = 512
num_patches = (img_size // patch_size) ** 2  # 64
use_spectre = True
spectre_threshold = 1.0

# Sample the mix permutations block-structured (whole 64-row blocks move;
# signs stay element-wise). The reference samples uniform tables: set
# mix_block = 0 to reproduce that distribution exactly. Parity tests carry
# the reference's own tables over and are unaffected by this default.
mix_block = 64

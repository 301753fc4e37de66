# SpectreBranch, the dual-path model (token trunk + frequency-domain CNN
# branch), on CIFAR-100 (the same values as the JAX package's
# spectre_tpu/configs/spectre_branch.py; the fusion width follows embed_dim).
_base_ = "default.py"

model = "spectre_branch"
method = "permut_mix"
dataset = "cifar100"

batch_size = 256
val_batch_size = 512
epochs = 100
num_classes = 100
patch_size = 4
img_size = 32
in_channels = 3
num_heads = 8
dropout = 0.001
hidden_dim = 256
activation = "gelu"
num_encoders = 4
embed_dim = 768
num_patches = (img_size // patch_size) ** 2
use_spectre = True
spectre_threshold = 1.0

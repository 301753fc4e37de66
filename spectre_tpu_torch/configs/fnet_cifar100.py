# FNet-style (fft_bare mixer) spectral ViT on CIFAR-100 (the same values as the
# JAX package's spectre_tpu/configs/fnet_cifar100.py).
_base_ = "default.py"

model = "spectre_vit"
method = "fft_bare"
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
activation = "gelu"
num_encoders = 4
embed_dim = 512
num_patches = (img_size // patch_size) ** 2
use_spectre = True
spectre_threshold = 1.0

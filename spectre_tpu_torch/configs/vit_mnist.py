# Baseline attention ViT-Tiny on MNIST, CPU-runnable (the same values as the
# JAX package's spectre_tpu/configs/vit_mnist.py).
_base_ = "default.py"

model = "vit"
method = "attention"
dataset = "mnist"

batch_size = 64
val_batch_size = 512
epochs = 5
num_classes = 10
patch_size = 4
img_size = 28
in_channels = 1
num_heads = 4
dropout = 0.001
hidden_dim = 256
activation = "gelu"
num_encoders = 4
embed_dim = 64
num_patches = (img_size // patch_size) ** 2
use_spectre = False
spectre_threshold = 1.0

# DINOv3-teacher -> SpectreViT-student distillation on CIFAR-100 (the same
# values as the JAX package's spectre_tpu/configs/distill_cifar100.py). The
# loss mix and temperature follow the reference recipe: soft-target KL at
# T=2 weighted 0.25 plus hard CE weighted 0.75. Teacher and student run on
# the same card.
_base_ = "spectre_vit_cifar100.py"

use_distillation = True
distill_temperature = 2.0
distill_alpha = 0.25
teacher = "dinov3_vits16"
teacher_img_size = 224        # the teacher's view is upsampled to it
teacher_embed_dim = 384
teacher_checkpoint = None     # an .npz of a torch state_dict (see distill/teacher.py)
# "imagenet" (default): bilinear resize + ImageNet statistics, what DINO
# teachers expect. "reference": the recipe's exact transform_dino (bicubic
# Resize(256) + CenterCrop(224) + CIFAR-100 statistics).
teacher_view = "imagenet"

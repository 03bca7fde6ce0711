"""Shared color-space constants for augmenters (counterpart of
``mxnet_tpu/utils/colorspace.py``; the single source for
``gluon.data.vision.transforms`` and, once ported, ``mx.image``)."""
import numpy as onp

# RGB↔YIQ (upstream image.py HueJitterAug matrices)
T_YIQ = onp.array([[0.299, 0.587, 0.114],
                   [0.596, -0.274, -0.321],
                   [0.211, -0.523, 0.311]], onp.float32)
T_RGB = onp.array([[1.0, 0.956, 0.621],
                   [1.0, -0.272, -0.647],
                   [1.0, -1.107, 1.705]], onp.float32)

# ITU-R BT.601 luma coefficients (gluon transforms / torchvision-style)
GRAY_COEF = onp.array([0.299, 0.587, 0.114], onp.float32)

# upstream mx.image.RandomGrayAug uses the BT.709-ish 0.21/0.72/0.07 mix
GRAY_COEF_IMAGE = onp.array([0.21, 0.72, 0.07], onp.float32)

# ImageNet PCA lighting (AlexNet; upstream CreateAugmenter defaults)
IMAGENET_PCA_EIGVAL = onp.array([55.46, 4.794, 1.148], onp.float32)
IMAGENET_PCA_EIGVEC = onp.array([[-0.5675, 0.7192, 0.4009],
                                 [-0.5808, -0.0045, -0.8140],
                                 [-0.5836, -0.6948, 0.4203]], onp.float32)

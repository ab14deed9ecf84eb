"""Image-fusion losses: SSIM, MS-SSIM, the Sobel gradient and the composite
fusion loss, with the small segmentation losses.

Port of ``medical_image_classification_tpu/train/fusion_losses.py``:
  fusion_loss = 10 * MS-SSIM term + 10 * MSE(max(Y, ir), gen)
              + 1 * L1(max(Sobel Y, Sobel ir) - Sobel gen)
with the Gaussian-window SSIM (VALID, the window shrunk to the image where
the image is smaller), the 5-level MS-SSIM weights, the (x + 1) / 2
normalisation and the reference's broadcast of the last level's SSIM into
every cs term.  The Gaussian blur runs as two 1-D depthwise convolutions
(the window is an outer product), the 2 x 2 pooling as ``avg_pool2d``.
Images NHWC, values in [0, 1]; every function computes in the input's
dtype (fp32 in the fusion step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_1d(window_size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(window_size, dtype=torch.float32,
                     device=device) - window_size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d(img, win1d):
    """Depthwise VALID Gaussian blur of an NCHW image: the window's column
    pass, then its row pass."""
    c, w = img.shape[1], win1d.shape[0]
    win = win1d.to(img.dtype)
    out = F.conv2d(img, win.view(1, 1, w, 1).expand(c, 1, w, 1), groups=c)
    return F.conv2d(out, win.view(1, 1, 1, w).expand(c, 1, 1, w), groups=c)


def _ssim_nchw(img1, img2, window_size: int, val_range, full: bool):
    L = 1.0 if val_range is None else val_range
    ws = min(window_size, img1.shape[2], img1.shape[3])
    window = _gaussian_1d(ws, device=img1.device)
    mu1, mu2 = _filter2d(img1, window), _filter2d(img2, window)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2d(img1 * img1, window) - mu1_sq
    s2 = _filter2d(img2 * img2, window) - mu2_sq
    s12 = _filter2d(img1 * img2, window) - mu12
    C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    v1 = 2.0 * s12 + C2
    v2 = s1 + s2 + C2
    ret = torch.mean(((2 * mu12 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2))
    if full:
        return ret, torch.mean(v1 / v2)
    return ret


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def ssim(img1, img2, window_size: int = 11, val_range: float | None = None,
         full: bool = False):
    """Gaussian-window SSIM of two NHWC images, VALID; with ``full`` also
    the contrast-structure term cs."""
    return _ssim_nchw(_nchw(img1), _nchw(img2), window_size, val_range, full)


def msssim(img1, img2, window_size: int = 11, normalize: bool = True):
    """5-level MS-SSIM with the reference weights.  As the reference does,
    the last level's SSIM multiplies every cs term before the product:
    prod(cs[:-1] ** w[:-1] * ssim[-1] ** w[-1])."""
    a, b = _nchw(img1), _nchw(img2)
    sims, css = [], []
    for level in range(5):
        if level:
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
        sim, cs = _ssim_nchw(a, b, window_size, None, True)
        sims.append(sim)
        css.append(cs)
    mssim, mcs = torch.stack(sims), torch.stack(css)
    if normalize:
        mssim, mcs = (mssim + 1) / 2, (mcs + 1) / 2
    w = torch.tensor(_MSSSIM_WEIGHTS, dtype=mssim.dtype, device=mssim.device)
    pow1, pow2 = mcs ** w, mssim ** w
    return torch.prod(pow1[:-1] * pow2[-1])


def sobel_grad(img):
    """|sobel_x| + |sobel_y| of a single-channel NHWC image (zero-padded
    to the same size)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device)
    ky = torch.tensor([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=img.dtype,
                      device=img.device)
    x = _nchw(img)
    g = (F.conv2d(x, kx.view(1, 1, 3, 3), padding=1).abs()
         + F.conv2d(x, ky.view(1, 1, 3, 3), padding=1).abs())
    return g.permute(0, 2, 3, 1)


def rgb_to_y(x):
    """ITU-R BT.601 luma of an NHWC RGB image."""
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def fusion_loss(image_vis, image_ir, generate_img, w_ssim: float = 10.0,
                w_in: float = 10.0, w_grad: float = 1.0):
    """The composite fusion loss of NHWC images in [0, 1] (the first
    channel of each input; the luma of a 3-channel fused image).  Returns
    (total, loss_in, ssim_term, loss_grad)."""
    image_y = image_vis[..., :1].clamp(0, 1)
    image_ir = image_ir[..., :1].clamp(0, 1)
    gen_y = (rgb_to_y(generate_img) if generate_img.shape[-1] == 3
             else generate_img).clamp(0, 1)
    x_in_max = torch.maximum(image_y, image_ir)
    ssim_term = (0.5 * (1 - msssim(gen_y, image_y, normalize=True))
                 + 0.5 * (1 - msssim(gen_y, image_ir, normalize=True)))
    loss_in = torch.mean((x_in_max - gen_y) ** 2)
    gen_g = sobel_grad(gen_y)
    loss_grad = torch.mean(torch.abs(
        torch.maximum(sobel_grad(image_y), sobel_grad(image_ir)) - gen_g))
    total = w_ssim * ssim_term + w_in * loss_in + w_grad * loss_grad
    return total, loss_in, ssim_term, loss_grad


# --- the segmentation losses --------------------------------------------------

def bce_loss(logits, targets):
    return -torch.mean(targets * F.logsigmoid(logits)
                       + (1 - targets) * F.logsigmoid(-logits))


def dice_loss(logits, targets, smooth: float = 1.0):
    probs = torch.sigmoid(logits)
    inter = torch.sum(probs * targets)
    return 1 - (2 * inter + smooth) / (torch.sum(probs) + torch.sum(targets)
                                       + smooth)


def ce_dice_loss(logits, targets, w_bce: float = 0.5, w_dice: float = 0.5):
    return w_bce * bce_loss(logits, targets) + w_dice * dice_loss(logits,
                                                                  targets)

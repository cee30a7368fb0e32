"""Model FLOPs of Stable Diffusion 1.5's UNet, ControlNet and VAE, counted
from the published shapes.

Each count is 2 x multiply-adds of the convolutions, the dense layers and
the attention products (q kᵀ and p v) of one forward pass of one image;
norms, activations and softmax are left out.  The widths come from the
configuration file's ``widths`` block (diffusers' UNet2DConditionModel,
ControlNetModel and AutoencoderKL at SD 1.5's published sizes).  The
counts read the same work whatever implements it: FRESCO's own extra work
(its attention masks, the feature optimization, background smoothing) is
not in them.
"""
from __future__ import annotations


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _dense(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def _attn(sq: int, sk: int, c: int) -> float:
    """q kᵀ and p v over all heads of total width ``c``."""
    return 4.0 * sq * sk * c


def _resnet(h: int, w: int, cin: int, cout: int, temb: int = 0) -> float:
    f = _conv(h, w, cin, cout) + _conv(h, w, cout, cout)
    if temb:
        f += _dense(1, temb, cout)
    if cin != cout:
        f += _dense(h * w, cin, cout)
    return f


def _transformer(h: int, w: int, c: int, ctx_len: int, ctx_dim: int) -> float:
    s = h * w
    f = 2 * _dense(s, c, c)                                   # proj_in, proj_out
    f += 4 * _dense(s, c, c) + _attn(s, s, c)                 # self-attention
    f += 2 * _dense(s, c, c) + 2 * _dense(ctx_len, ctx_dim, c) + _attn(s, ctx_len, c)  # cross-attention
    f += _dense(s, c, 8 * c) + _dense(s, 4 * c, c)            # GEGLU feed-forward
    return f


def _encoder(h: int, w: int, u: dict, temb: int, ctx_len: int) -> tuple[float, list[tuple[int, int, int]]]:
    """The UNet's conv_in, down blocks and mid block (shared with the
    ControlNet); returns (FLOPs, the skips' (h, w, channels))."""
    chans, layers, ctx = u["block_out_channels"], u["layers_per_block"], u["cross_attention_dim"]
    f = _conv(h, w, u["in_channels"], chans[0])
    skips = [(h, w, chans[0])]
    cin = chans[0]
    for i, cout in enumerate(chans):
        for _ in range(layers):
            f += _resnet(h, w, cin, cout, temb)
            if i < len(chans) - 1:
                f += _transformer(h, w, cout, ctx_len, ctx)
            cin = cout
            skips.append((h, w, cout))
        if i < len(chans) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            f += _conv(h, w, cout, cout)
            skips.append((h, w, cout))
    mid = chans[-1]
    f += 2 * _resnet(h, w, mid, mid, temb) + _transformer(h, w, mid, ctx_len, ctx)
    return f, skips


def _time_embedding(c0: int) -> float:
    return _dense(1, c0, 4 * c0) + _dense(1, 4 * c0, 4 * c0)


def unet_flops(h: int, w: int, u: dict, ctx_len: int = 77) -> float:
    """One UNet pass of one latent of h x w."""
    chans, layers, ctx = u["block_out_channels"], u["layers_per_block"], u["cross_attention_dim"]
    temb = 4 * chans[0]
    f, skips = _encoder(h, w, u, temb, ctx_len)
    f += _time_embedding(chans[0])
    rev = list(reversed(chans))
    prev = rev[0]
    hh, ww = skips[-1][0], skips[-1][1]
    for j, cout in enumerate(rev):
        for _ in range(layers + 1):
            sh, sw, sc = skips.pop()
            f += _resnet(hh, ww, prev + sc, cout, temb)
            if j > 0:
                f += _transformer(hh, ww, cout, ctx_len, ctx)
            prev = cout
        if j < len(rev) - 1:
            hh, ww = skips[-1][0], skips[-1][1]
            f += _conv(hh, ww, cout, cout)
    f += _conv(hh, ww, chans[0], u["out_channels"])
    return f


def controlnet_flops(h: int, w: int, u: dict, cond: list[int], ctx_len: int = 77) -> float:
    """One ControlNet pass of one latent of h x w (its condition image 8x
    larger): the conditioning embedding, the UNet's encoder and mid block,
    and a zero convolution on every skip and on the mid block."""
    chans = u["block_out_channels"]
    H, W = 8 * h, 8 * w
    f = _conv(H, W, 3, cond[0])
    for i in range(len(cond) - 1):
        f += _conv(H, W, cond[i], cond[i])
        H, W = (H + 1) // 2, (W + 1) // 2
        f += _conv(H, W, cond[i], cond[i + 1])
    f += _conv(H, W, cond[-1], chans[0])
    enc, skips = _encoder(h, w, u, 4 * chans[0], ctx_len)
    f += enc + _time_embedding(chans[0])
    f += sum(_dense(sh * sw, sc, sc) for sh, sw, sc in skips)
    f += _dense(skips[-1][0] * skips[-1][1], chans[-1], chans[-1])
    return f


def _vae_mid(h: int, w: int, c: int) -> float:
    return 2 * _resnet(h, w, c, c) + 4 * _dense(h * w, c, c) + _attn(h * w, h * w, c)


def vae_encode_flops(H: int, W: int, v: dict) -> float:
    """One VAE encode of one H x W image."""
    chans, layers, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    f = _conv(H, W, v["in_channels"], chans[0])
    cin = chans[0]
    h, w = H, W
    for i, cout in enumerate(chans):
        for _ in range(layers):
            f += _resnet(h, w, cin, cout)
            cin = cout
        if i < len(chans) - 1:
            h, w = h // 2, w // 2
            f += _conv(h, w, cout, cout)
    f += _vae_mid(h, w, chans[-1])
    f += _conv(h, w, chans[-1], 2 * lat) + _dense(h * w, 2 * lat, 2 * lat)
    return f


def vae_decode_flops(h: int, w: int, v: dict) -> float:
    """One VAE decode of one h x w latent."""
    chans, layers, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    rev = list(reversed(chans))
    f = _dense(h * w, lat, lat) + _conv(h, w, lat, rev[0]) + _vae_mid(h, w, rev[0])
    cin = rev[0]
    for j, cout in enumerate(rev):
        for _ in range(layers + 1):
            f += _resnet(h, w, cin, cout)
            cin = cout
        if j < len(rev) - 1:
            h, w = 2 * h, 2 * w
            f += _conv(h, w, cout, cout)
    f += _conv(h, w, rev[-1], v["in_channels"])
    return f


def denoise_batch_flops(spec: dict, n_images: int, height: int, width: int) -> float:
    """Model FLOPs of one keyframe batch of ``n_images`` at height x width:
    the denoising steps after warm-up, each a ControlNet and a UNet pass of
    the CFG-doubled batch, plus the VAE's encode and decode of the batch."""
    fr, wd = spec["fresco"], spec["widths"]
    h, w = height // 8, width // 8
    steps = fr["num_inference_steps"] - max(fr["num_warmup_steps"], 0)
    per_image_step = unet_flops(h, w, wd["unet"])
    if fr.get("use_controlnet", True):
        per_image_step += controlnet_flops(h, w, wd["unet"], wd["controlnet"]["conditioning_embedding_out_channels"])
    return (steps * 2 * n_images * per_image_step
            + n_images * (vae_encode_flops(height, width, wd["vae"]) + vae_decode_flops(h, w, wd["vae"])))

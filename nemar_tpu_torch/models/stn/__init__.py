"""STN registry (reference ``define_stn``): the UNet deformable STN.

``--stn_type affine`` and ``--stn_multiscale`` are queued as ROADMAP.md A4.
"""

from nemar_tpu_torch.models.stn.unet_stn import UnetSTN, smoothness_loss

_QUEUED = "queued as ROADMAP.md A4"


def define_stn(opt, stn_type: str) -> UnetSTN:
    """Build R from the option flags (reference ``define_stn``)."""
    # φ's input pair: (real_A, real_B), or (fake_B, real_B) with
    # --stn_field_source fake
    src_nc = opt.output_nc if getattr(opt, "stn_field_source", "pair") == "fake" else opt.input_nc
    if stn_type == "affine":
        raise NotImplementedError(f"stn type 'affine' is not ported yet ({_QUEUED})")
    if stn_type != "unet":
        raise NotImplementedError(f"stn type {stn_type!r}")
    if getattr(opt, "stn_multiscale", False):
        raise NotImplementedError(f"--stn_multiscale is not ported yet ({_QUEUED})")
    return UnetSTN(
        in_channels=src_nc + opt.output_nc,
        ngf=getattr(opt, "stn_ngf", 32),
        depth=getattr(opt, "stn_depth", 5),
        flow_scale=getattr(opt, "stn_flow_scale", 1.0),
        smooth_type=getattr(opt, "stn_smooth_type", "l1"),
        smooth_order=getattr(opt, "stn_smooth_order", 1),
        padding_mode=getattr(opt, "stn_padding_mode", "zeros"),
        align_corners=getattr(opt, "stn_align_corners", False),
        bounded_flow=getattr(opt, "stn_bounded_flow", 0.0),
        level_scale=getattr(opt, "stn_level_scale", 1.0),
    )


__all__ = ["UnetSTN", "define_stn", "smoothness_loss"]

"""STN registry (reference ``define_stn``): the UNet deformable STN, with
its multiscale heads, and the affine STN."""

from nemar_tpu_torch.models.stn.affine_stn import AffineSTN
from nemar_tpu_torch.models.stn.unet_stn import UnetSTN, resize_bilinear, smoothness_loss


def define_stn(opt, stn_type: str):
    """Build R from the option flags (reference ``define_stn``)."""
    # φ's input pair: (real_A, real_B), or (fake_B, real_B) with
    # --stn_field_source fake
    src_nc = opt.output_nc if getattr(opt, "stn_field_source", "pair") == "fake" else opt.input_nc
    common = dict(in_channels=src_nc + opt.output_nc, ngf=getattr(opt, "stn_ngf", 32),
                  padding_mode=getattr(opt, "stn_padding_mode", "zeros"),
                  align_corners=getattr(opt, "stn_align_corners", False))
    size = getattr(opt, "crop_size", 256)
    if stn_type == "affine":
        return AffineSTN(**common, head=getattr(opt, "stn_affine_head", "flatten"), size=size)
    if stn_type == "unet":
        return UnetSTN(
            **common,
            depth=getattr(opt, "stn_depth", 5),
            flow_scale=getattr(opt, "stn_flow_scale", 1.0),
            smooth_type=getattr(opt, "stn_smooth_type", "l1"),
            smooth_order=getattr(opt, "stn_smooth_order", 1),
            bounded_flow=getattr(opt, "stn_bounded_flow", 0.0),
            multiscale=getattr(opt, "stn_multiscale", False),
            level_scale=getattr(opt, "stn_level_scale", 1.0),
            head_min_res=getattr(opt, "stn_head_min_res", 0),
            size=size,
        )
    raise NotImplementedError(f"stn type {stn_type!r}")


__all__ = ["AffineSTN", "UnetSTN", "define_stn", "resize_bilinear", "smoothness_loss"]

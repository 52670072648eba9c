from rmem_tpu_torch.models.decoders.fpn import FPNSegmentationHead  # noqa: F401


def build_decoder(name: str, **kw):
    if name == "fpn":
        return FPNSegmentationHead(**kw)
    raise NotImplementedError(f"decoder {name!r}")

from .model import AudioUNet3D, UNet3DConfig  # noqa: F401

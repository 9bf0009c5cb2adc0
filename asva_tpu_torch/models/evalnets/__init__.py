from .i3d import InceptionI3D  # noqa: F401
from .inception_v3 import InceptionV3FID  # noqa: F401

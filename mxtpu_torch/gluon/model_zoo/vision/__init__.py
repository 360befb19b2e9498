"""Vision model zoo of the port (ResNet v1 so far)."""
from .resnet import *  # noqa: F401,F403

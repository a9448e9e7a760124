from . import linalg, se3, so3
from .se3 import Pose3

from . import geodesy
from .anpp import AnppDecoder, NavFrame, interpolate
from .geodesy import lla2ned, ned2lla, symmetrical_angle
from .imu_config import ImuConfig

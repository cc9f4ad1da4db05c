from .resize import interpolate, resize_hw
from .ms_deform_attn import ms_deform_attn
from .position_encoding import position_embedding_sine

from .resize import grid_sample, interpolate, resize_hw
from .ms_deform_attn import ms_deform_attn_fused
from .position_encoding import position_embedding_sine
from .neighborhood_attention import neighborhood_attention_2d

from .adamw import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                    global_norm, clip_by_global_norm)
from .compression import (compress_int8, decompress_int8, compressed_psum,
                          CompressedAccumulator)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "compress_int8",
           "decompress_int8", "compressed_psum", "CompressedAccumulator"]

"""Core SeDA crypto in plain torch: AES, CTR, B-AES, NH MACs, keys."""

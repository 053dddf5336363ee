# AdamW with f32 masters and gradient compression.

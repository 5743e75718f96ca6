"""AdamW and gradient compression over dicts of tensors."""

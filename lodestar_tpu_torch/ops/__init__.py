"""Device-tier field, tower, curve and pairing ops on int32 limb tensors."""

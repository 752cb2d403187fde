"""Losses and domain alignment of the training stages."""

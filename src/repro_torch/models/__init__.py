"""Executable GAN models."""

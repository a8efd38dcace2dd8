"""Serving: bucketed STDService and its batching helpers."""

"""Trainers of the port: the U-Net (full-frame and crop) and YOLOv8n."""

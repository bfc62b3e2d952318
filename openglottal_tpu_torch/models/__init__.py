"""Networks (YOLOv8n, U-Net), the temporal gate and the guided tracker."""

"""The port's command line: ``python -m amyloid_yolo_tpu_torch.cli`` (see
:mod:`.main`)."""

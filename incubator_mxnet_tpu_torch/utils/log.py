"""Logging facade (twin of ``incubator_mxnet_tpu/utils/log.py``; role
of dmlc LOG/CHECK in the reference)."""
import logging

_FMT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"


def get_logger(name="mxtpu", level=None):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.propagate = False
    if level is not None:
        logger.setLevel(level)
    elif logger.level == logging.NOTSET:
        logger.setLevel(logging.INFO)
    return logger

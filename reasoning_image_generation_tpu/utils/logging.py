# logging.py — structured logging (console / plain-file / JSON-file).
"""Logger setup matching the reference's observability surface
(multigraph_generation/logger.py:8-78): console handler always, optional
plain file, optional JSON-structured file with
timestamp/level/logger/message/path/func/line/exc_info fields, duplicate-
handler guards, propagate=False."""
from __future__ import annotations

import json
import logging
import os
from datetime import datetime


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "timestamp": datetime.fromtimestamp(record.created).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "path": record.pathname,
            "func": record.funcName,
            "line": record.lineno,
        }
        if record.exc_info:
            entry["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(entry, ensure_ascii=False)


def setup_logger(name: str = "rig", log_level: str = "INFO",
                 log_file: str | None = None,
                 json_log_file: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, log_level.upper(), logging.INFO))
    logger.propagate = False

    def has_handler(kind, path=None):
        for h in logger.handlers:
            if isinstance(h, kind) and (path is None or
                                        getattr(h, "baseFilename", None) == path):
                return True
        return False

    if not has_handler(logging.StreamHandler):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(sh)
    if log_file:
        path = os.path.abspath(log_file)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not has_handler(logging.FileHandler, path):
            fh = logging.FileHandler(path, encoding="utf-8")
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            logger.addHandler(fh)
    if json_log_file:
        path = os.path.abspath(json_log_file)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not has_handler(logging.FileHandler, path):
            jh = logging.FileHandler(path, encoding="utf-8")
            jh.setFormatter(JsonFormatter())
            logger.addHandler(jh)
    return logger

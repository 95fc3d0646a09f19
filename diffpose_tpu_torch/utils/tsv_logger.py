"""TSV training-curve logger with resume and matplotlib plotting.

Capability parity with the reference ``common/log.py:20-98`` (``Logger``,
``LoggerMonitor``): a tab-separated metrics file (one header row, one row
per append) plus simple overlay plotting — file-format compatible so
existing reference log files can be loaded with ``resume=True``.

Counterpart of ``diffpose_tpu/utils/tsv_logger.py`` (this package keeps its own copy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class Logger:
    def __init__(self, fpath: Optional[str], title: Optional[str] = None, resume: bool = False):
        self.file = None
        self.resume = resume
        self.title = "" if title is None else title
        self.names: List[str] = []
        self.numbers: Dict[str, list] = {}
        if fpath is not None:
            if resume:
                with open(fpath, "r") as f:
                    header = f.readline()
                    self.names = header.rstrip().split("\t")
                    self.numbers = {name: [] for name in self.names}
                    for line in f:
                        row = line.rstrip().split("\t")
                        for i, v in enumerate(row):
                            self.numbers[self.names[i]].append(v)
                self.file = open(fpath, "a")
            else:
                self.file = open(fpath, "w")

    def set_names(self, names: Sequence[str]):
        self.names = list(names)
        self.numbers = {name: [] for name in self.names}
        if self.file is not None and not self.resume:
            for name in self.names:
                self.file.write(name)
                self.file.write("\t")
            self.file.write("\n")
            self.file.flush()

    def append(self, numbers: Sequence[float]):
        assert len(self.names) == len(numbers), "Numbers do not match names"
        for index, num in enumerate(numbers):
            if self.file is not None:
                self.file.write("{0:.6f}".format(num))
                self.file.write("\t")
            self.numbers[self.names[index]].append(num)
        if self.file is not None:
            self.file.write("\n")
            self.file.flush()

    def plot(self, names: Optional[Sequence[str]] = None):
        import matplotlib.pyplot as plt
        import numpy as np

        names = self.names if names is None else names
        for name in names:
            x = np.arange(len(self.numbers[name]))
            plt.plot(x, np.asarray(self.numbers[name], dtype=float))
        plt.legend([f"{self.title}({name})" for name in names])
        plt.grid(True)

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LoggerMonitor:
    """Overlay-plot several TSV logs ({title: path})."""

    def __init__(self, paths: Dict[str, str]):
        self.loggers = [Logger(path, title=title, resume=True) for title, path in paths.items()]

    def plot(self, names: Optional[Sequence[str]] = None):
        import matplotlib.pyplot as plt
        import numpy as np

        plt.figure()
        plt.subplot(121)
        legend = []
        for logger in self.loggers:
            sel = logger.names if names is None else names
            for name in sel:
                x = np.arange(len(logger.numbers[name]))
                plt.plot(x, np.asarray(logger.numbers[name], dtype=float))
            legend += [f"{logger.title}({name})" for name in sel]
        plt.legend(legend, bbox_to_anchor=(1.05, 1), loc=2, borderaxespad=0.0)
        plt.grid(True)


def savefig(fname: str, dpi: Optional[int] = 150):
    import matplotlib.pyplot as plt

    plt.savefig(fname, dpi=dpi)

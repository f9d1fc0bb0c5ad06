"""Dataset catalogs: sample lists per dataset (reference:
datasets/classification/{ucf101,hmdb51,kinetics,smth_smth}.py).

A catalog is a sequence of Sample(video_path, class_index). File formats are
kept byte-compatible with the reference so existing dataset layouts work
unchanged. A synthetic catalog provides procedurally generated videos for
tests and benchmarks.
"""
from __future__ import annotations

import glob
import json
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


@dataclass
class Sample:
    video_path: str
    class_index: int


def _find_with_extensions(path: Path, extensions) -> Path:
    for ext in extensions:
        p = path.with_suffix(ext)
        if p.exists():
            return p
    raise FileNotFoundError(
        f"{path} with possible extensions {extensions} not found")


class UCF101:
    """classInd.txt + {train,test}list{fold}.txt
    (reference: ucf101.py:18-79)."""

    def __init__(self, video_dir, annotation_dir, fold=1, split="train",
                 extensions=(".avi", ".mp4")):
        annotation_dir = Path(annotation_dir)
        class_idx = self._read_class_idx(annotation_dir)
        self.index_to_class = list(class_idx.values())
        self.class_to_index = {v: k - 1 for k, v in class_idx.items()}

        list_name = {"train": "train", "val": "test", "test": "test"}[split]
        list_path = annotation_dir / f"{list_name}list{fold:02d}.txt"
        self.samples: List[Sample] = []
        with list_path.open() as f:
            for line in f:
                video = line.strip().split(" ")[0]
                if not video:
                    continue
                video_path = _find_with_extensions(
                    Path(video_dir) / video, extensions)
                class_name = video_path.parts[-2]
                self.samples.append(Sample(
                    str(video_path), self.class_to_index[class_name]))

    @staticmethod
    def _read_class_idx(annotation_dir: Path) -> Dict[int, str]:
        out = OrderedDict()
        with (annotation_dir / "classInd.txt").open() as f:
            for line in f:
                idx, name = line.strip().split(" ")
                out[int(idx)] = name
        return out

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class HMDB51:
    """Directory scan + *_test_split{fold}.txt tag files
    (reference: hmdb51.py:9-81; tag 1=train, 2=test)."""

    def __init__(self, video_dir, annotation_dir, fold=1, split="train",
                 extensions=(".avi", ".mp4")):
        classes = sorted(p for p in os.listdir(video_dir)
                         if os.path.isdir(os.path.join(video_dir, p)))
        self.class_to_index = {c: i for i, c in enumerate(classes)}
        self.index_to_class = classes
        target_tag = {"train": 1, "val": 2, "test": 2}[split]

        selected = set()
        pattern = os.path.join(annotation_dir, f"*test_split{fold}.txt")
        for ann_path in glob.glob(pattern):
            with open(ann_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2 and int(parts[1]) == target_tag:
                        selected.add(parts[0])

        self.samples: List[Sample] = []
        exts = tuple(e.lower() for e in extensions)
        for class_name in classes:
            class_dir = os.path.join(video_dir, class_name)
            # match torchvision make_dataset (the reference's walker):
            # case-insensitive extension, recursive walk of the class dir
            for dirpath, _dirnames, fnames in sorted(os.walk(class_dir)):
                for fname in sorted(fnames):
                    if (fname in selected
                            and fname.lower().endswith(exts)):
                        self.samples.append(Sample(
                            os.path.join(dirpath, fname),
                            self.class_to_index[class_name]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class Kinetics:
    """{split}_video/<class>/<file> glob with corrupt-file blacklist
    (reference: kinetics.py:8-45)."""

    def __init__(self, video_dir, split="train", blacklist=None):
        video_dir = Path(video_dir)
        blacklist = set(blacklist or [])
        self._class_names = sorted(
            set(p.name for p in video_dir.glob("*_video/*")))
        self.class_to_index = {n: i for i, n in enumerate(self._class_names)}
        self.index_to_class = self._class_names

        self.samples: List[Sample] = []
        blacklisted = 0
        for video_path in sorted((video_dir / f"{split}_video").glob("*/*")):
            if str(video_path.relative_to(video_dir)) in blacklist:
                blacklisted += 1
                continue
            self.samples.append(Sample(
                str(video_path),
                self.class_to_index[video_path.parts[-2]]))
        if not self.samples:
            raise FileNotFoundError(f"No video found in {video_dir}/{split}_video")
        logger.info("%s split: %d classes, %d videos, %d blacklisted",
                    split, len(self._class_names), len(self.samples),
                    blacklisted)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class SmthSmth:
    """something-something-v2 JSON annotations (reference: smth_smth.py:10-57)."""

    def __init__(self, video_dir, annotation_dir, split="train"):
        annotation_dir = Path(annotation_dir)
        with (annotation_dir / "something-something-v2-labels.json").open() as f:
            self.class_idx_dict = json.load(f)
        list_name = {"train": "train", "val": "validation",
                     "test": "validation"}[split]
        path = annotation_dir / f"something-something-v2-{list_name}.json"
        self.samples: List[Sample] = []
        with path.open() as f:
            for info in json.load(f):
                class_name = info["template"].replace("[", "").replace("]", "")
                self.samples.append(Sample(
                    str(Path(video_dir) / f"{int(info['id'])}.mp4"),
                    int(self.class_idx_dict[class_name])))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class Synthetic:
    """Procedural videos for tests/benchmarks: path 'synthetic://<seed>'.

    Labels encode the motion direction of a moving square so a model can
    actually learn from this data (used by --debug smoke training and
    benchmarks).
    """

    def __init__(self, num_samples=256, num_classes=10, split="train",
                 num_frames=64, height=128, width=171,
                 class_mode="direction"):
        base = 0 if split == "train" else 10 ** 6
        self.num_classes = num_classes
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.samples = []
        for i in range(num_samples):
            cls = i % num_classes
            url = (f"synthetic://{base + i}?frames={num_frames}"
                   f"&h={height}&w={width}&cls={cls}")
            if class_mode == "speed":
                # class carries only the movement speed — invariant to
                # flips/crops/color augs, the RSP-transfer probe target
                url += f"&speed={0.4 + 0.5 * cls:.3f}"
            elif class_mode != "direction":
                raise ValueError(f"unknown class_mode {class_mode!r}")
            self.samples.append(Sample(url, cls))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def build_catalog(cfg, split: str):
    """ConfigTree dataset.* -> catalog (reference wires this inside
    DataLoaderFactoryV3, datasets/classification/__init__.py:64-128)."""
    name = cfg.get_string("dataset.name")
    root = cfg.get_string("dataset.root", "")
    if name == "ucf101":
        return UCF101(root, cfg.get_string("dataset.annotation_path"),
                      fold=cfg.get_int("dataset.fold", 1), split=split)
    if name == "hmdb51":
        return HMDB51(root, cfg.get_string("dataset.annotation_path"),
                      fold=cfg.get_int("dataset.fold", 1), split=split)
    if name.startswith("kinetics"):
        # the reference matches any kinetics* variant
        # (datasets/classification/__init__.py:92)
        return Kinetics(root, split=split,
                        blacklist=cfg.get_list("dataset.blacklist", []))
    if name == "smth_smth":
        return SmthSmth(root, cfg.get_string("dataset.annotation_path"),
                        split=split)
    if name == "synthetic":
        num_samples = cfg.get_int("dataset.num_samples", 256)
        if split != "train":
            # the port's own key: a validation split of another size
            num_samples = cfg.get_int("dataset.val_num_samples", num_samples)
        return Synthetic(
            num_samples=num_samples,
            num_classes=cfg.get_int("dataset.num_classes", 10),
            split=split,
            num_frames=cfg.get_int("dataset.num_frames", 64),
            height=cfg.get_int("dataset.height", 128),
            width=cfg.get_int("dataset.width", 171),
            class_mode=cfg.get_string("dataset.class_mode", "direction"))
    raise ValueError(f"Unknown dataset {name!r}")

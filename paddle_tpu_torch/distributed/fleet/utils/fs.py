"""Filesystem clients (the port's copy of
``paddle_tpu/distributed/fleet/utils/fs.py``) — parity with
python/paddle/distributed/fleet/utils/fs.py (`FS` abstract, `LocalFS`,
`HDFSClient` shelling out to the hadoop CLI) feeding the checkpoint
machinery (fluid/incubate/checkpoint/auto_checkpoint.py:636 saves through
an fs client so jobs can resume from remote storage).

TPU-native deployment stores checkpoints on GCS as often as HDFS, so a
`GCSClient` (gsutil CLI) ships alongside `HDFSClient`; both share the
subprocess plumbing.  Remote clients raise a clear error at first use when
their CLI is absent — never a silent no-op.
"""
from __future__ import annotations

import os
import shutil
import subprocess


class ExecuteError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    """fs.py `FS` abstract surface."""

    def ls_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def rename(self, src, dst):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        return self.rename(src, dst)

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError

    def need_upload_download(self) -> bool:
        """True for remote filesystems (reference fs.py same hook): the
        checkpoint saver then stages through a local temp dir."""
        return True


class LocalFS(FS):
    """fs.py `LocalFS` parity."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            (dirs if os.path.isdir(full) else files).append(name)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst):
        os.replace(src, dst)

    def upload(self, local_path, fs_path):
        if os.path.abspath(local_path) == os.path.abspath(fs_path):
            return
        self.mkdirs(os.path.dirname(fs_path) or ".")
        if os.path.isdir(local_path):
            if os.path.exists(fs_path):
                shutil.rmtree(fs_path)
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy2(local_path, fs_path)

    def download(self, fs_path, local_path):
        if not self.is_exist(fs_path):
            raise FSFileNotExistsError(fs_path)
        self.upload(fs_path, local_path)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path) and not exist_ok:
            raise ExecuteError(f"{path} exists")
        open(path, "a").close()

    def need_upload_download(self) -> bool:
        return False


class _CliFS(FS):
    """Shared subprocess plumbing for CLI-backed remote filesystems."""

    _CLI: list[str] = []
    _NAME = "remote"

    def _run(self, *args, check=True):
        cli = self._cli()
        proc = subprocess.run(cli + list(args), capture_output=True,
                              text=True)
        if check and proc.returncode != 0:
            raise ExecuteError(
                f"{' '.join(cli + list(args))} failed "
                f"(rc={proc.returncode}): {proc.stderr.strip()[:500]}")
        return proc

    def _cli(self):
        exe = self._CLI[0]
        if shutil.which(exe) is None:
            raise ExecuteError(
                f"{self._NAME} client needs the `{exe}` CLI on PATH; "
                f"install it or use LocalFS paths")
        return list(self._CLI)


class HDFSClient(_CliFS):
    """fs.py `HDFSClient` parity: shells out to `hadoop fs` exactly like
    the reference (which wraps the same CLI with retries)."""

    _NAME = "HDFS"

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                  if hadoop_home else "hadoop")
        self._CLI = [hadoop, "fs"]
        for k, v in (configs or {}).items():
            self._CLI += [f"-D{k}={v}"]

    def ls_dir(self, path):
        proc = self._run("-ls", path, check=False)
        if proc.returncode != 0:
            return [], []
        dirs, files = [], []
        for line in proc.stdout.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return sorted(dirs), sorted(files)

    def is_dir(self, path):
        return self._run("-test", "-d", path, check=False).returncode == 0

    def is_file(self, path):
        return self._run("-test", "-f", path, check=False).returncode == 0

    def is_exist(self, path):
        return self._run("-test", "-e", path, check=False).returncode == 0

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def rename(self, src, dst):
        self._run("-mv", src, dst)

    def upload(self, local_path, fs_path):
        self.mkdirs(os.path.dirname(fs_path) or "/")
        self._run("-put", "-f", local_path, fs_path)

    def download(self, fs_path, local_path):
        if not self.is_exist(fs_path):
            raise FSFileNotExistsError(fs_path)
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        self._run("-get", fs_path, local_path)

    def touch(self, path, exist_ok=True):
        if not exist_ok and self.is_exist(path):
            raise ExecuteError(f"{path} exists")
        self._run("-touchz", path)


class GCSClient(_CliFS):
    """GCS checkpoint storage via the `gsutil` CLI (the TPU-native
    deployment analog of the reference's HDFS client)."""

    _CLI = ["gsutil"]
    _NAME = "GCS"

    def ls_dir(self, path):
        proc = self._run("ls", path.rstrip("/") + "/", check=False)
        if proc.returncode != 0:
            return [], []
        dirs, files = [], []
        for line in proc.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            name = os.path.basename(line.rstrip("/"))
            (dirs if line.endswith("/") else files).append(name)
        return sorted(dirs), sorted(files)

    def is_exist(self, path):
        return self._run("ls", path, check=False).returncode == 0

    def is_dir(self, path):
        return self._run("ls", path.rstrip("/") + "/",
                         check=False).returncode == 0

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def mkdirs(self, path):
        pass  # GCS has no directories; objects create their prefixes

    def delete(self, path):
        self._run("-m", "rm", "-r", "-f", path, check=False)

    def rename(self, src, dst):
        self._run("-m", "mv", src, dst)

    def upload(self, local_path, fs_path):
        if os.path.isdir(local_path):
            self._run("-m", "cp", "-r", local_path, fs_path)
        else:
            self._run("cp", local_path, fs_path)

    def download(self, fs_path, local_path):
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        proc = self._run("-m", "cp", "-r", fs_path, local_path, check=False)
        if proc.returncode != 0:
            raise FSFileNotExistsError(fs_path)

    def touch(self, path, exist_ok=True):
        import tempfile
        with tempfile.NamedTemporaryFile() as f:
            self.upload(f.name, path)

"""Executable documentation: README and docstring examples run in CI.

The reference runs its documentation examples as doc tests
(src/lib.rs:3-9, src/options.rs:38-58, 599-605); a broken example fails
its build.  Same contract here: every ```python fence in README.md and
the `Example:` block in the api module docstring are executed — a doc
drift (renamed symbol, changed signature, wrong path) fails this test.

The CLI bash examples are covered by the CI packaging job (installs the
wheel and runs the console script end-to-end) and tests/test_cli.py.
"""

import re
import shutil

import pytest

from conftest import REPO_ROOT


def _python_fences(text: str) -> list[str]:
    return re.findall(r"```python\n(.*?)```", text, flags=re.DOTALL)


def test_readme_python_examples(tmp_path, monkeypatch, example_cif):
    readme = (REPO_ROOT / "README.md").read_text()
    blocks = _python_fences(readme)
    assert blocks, "README has no python examples to execute"
    # Examples reference a generic "protein.cif"; provide a real one.
    shutil.copy(example_cif, tmp_path / "protein.cif")
    monkeypatch.chdir(tmp_path)
    for i, block in enumerate(blocks):
        exec(compile(block, f"README.md[python block {i}]", "exec"), {})


def test_api_docstring_example(monkeypatch):
    import rustsasa_jax.api as api

    doc = api.__doc__ or ""
    m = re.search(r"Example:\n(.*)", doc, flags=re.DOTALL)
    assert m, "api module docstring lost its Example section"
    code = "\n".join(
        line[4:] if line.startswith("    ") else line
        for line in m.group(1).splitlines()
    )
    assert "read_structure" in code
    # The example uses a repo-relative fixture path.
    monkeypatch.chdir(REPO_ROOT)
    ns: dict = {}
    exec(compile(code, "rustsasa_jax/api.py[docstring]", "exec"), ns)
    result = ns.get("result")
    assert result is not None and len(result.residues) == 330


def test_readme_quickstart_values(tmp_path, monkeypatch, example_cif, capsys):
    """The quick-start block must also produce sane output, not just run."""
    readme = (REPO_ROOT / "README.md").read_text()
    block = next(
        b for b in _python_fences(readme) if "read_structure" in b
    )
    shutil.copy(example_cif, tmp_path / "protein.cif")
    monkeypatch.chdir(tmp_path)
    ns: dict = {}
    exec(compile(block, "README.md[quickstart]", "exec"), ns)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 3
    first = printed[0].split()
    assert first[2] == "MET" and float(first[3]) == pytest.approx(
        220.1, abs=1.0
    )

"""tools/sass_diff's parsing and comparison on `cuobjdump -sass`-shaped
text (the tool runs `cuobjdump` on the card's host; nothing here needs it)."""

from cips3dpp_torch.tools.sass_diff import compare, parse_sass

DUMP = """
	code for sm_90a
		Function : _Z1fv
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
		Function : _Z1gv
        /*0000*/                   EXIT ;                                    /* 0x000000000000794d */
"""


def test_parse_sass_strips_addresses():
    """An instruction keeps its text and first encoding word; its address
    and the control word on the next line are dropped."""
    funcs = parse_sass(DUMP)
    assert funcs == {
        "_Z1fv": ["LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */",
                  "S2R R0, SR_TID.X ; /* 0x0000000000007919 */"],
        "_Z1gv": ["EXIT ; /* 0x000000000000794d */"]}


def test_compare_counts_differing_lines_of_common_entries():
    a = parse_sass(DUMP)
    moved = DUMP.replace("/*0010*/", "/*0020*/").replace("0x000fe20000000800", "0x0")
    changed = DUMP.replace("SR_TID.X", "SR_TID.Y") + "\t\tFunction : _Z1hv\n"
    assert compare(a, parse_sass(moved)) == {"_Z1fv": 0, "_Z1gv": 0}
    assert compare(a, parse_sass(changed)) == {"_Z1fv": 1, "_Z1gv": 0}
    assert compare(a, parse_sass(changed), match="1f") == {"_Z1fv": 1}


def test_anonymous_namespace_entries_pair_across_edited_sources():
    """nvcc names an anonymous namespace by hashes of its file's contents:
    the same kernel of an edited source pairs with the parent's."""
    old = DUMP.replace("_Z1gv", "_ZN48_GLOBAL__N__0d9ccce3_15_siren_render_cu_7487e3a84kernEv")
    new = DUMP.replace("_Z1gv", "_ZN48_GLOBAL__N__1a2b3c4d_15_siren_render_cu_deadbeef4kernEv")
    a, b = parse_sass(old), parse_sass(new)
    assert list(a) == list(b) == ["_Z1fv", "_ZN48_GLOBAL__N___15_siren_render_cu_4kernEv"]
    assert compare(a, b) == {"_Z1fv": 0, "_ZN48_GLOBAL__N___15_siren_render_cu_4kernEv": 0}

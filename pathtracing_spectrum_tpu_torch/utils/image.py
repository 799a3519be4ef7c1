"""Host image files without PIL: texture loading, the image writer, and the
reference's nearest sampling.

Port of ``pathtracing_spectrum_tpu/utils/image.py``. The JAX package
decodes and saves through PIL; the port must not import it (the machine
with the card has none), so it reads and writes each format itself.

Reading: :func:`load_rgba` names the format as PIL 12.1's ``Image.open``
does, by the same tests in the same order (``_PIL_OPENS``: each plugin's
``_accept`` test of the leading bytes, or for the six without one the
header check its ``_open`` starts with), never by the extension, and its
output equals PIL's ``convert("RGBA")`` divided by 255, bit for bit:

- PNG, with the standard library's ``zlib`` and the five row filters in
  numpy: colour types 0 (grey, 1/2/4/8/16 bits), 2 (RGB), 3 (palette,
  1/2/4/8 bits), 4 (grey + alpha) and 6 (RGBA), 8 or 16 bits, plain or
  Adam7-interlaced; ``tRNS`` as PIL applies it; 16-bit samples keep their
  high byte, as PIL does for colour types 2, 4 and 6; damaged as PIL reads
  it: the CRCs of the chunks before the image data checked, none after,
  no IEND needed, the image data inflated in PIL's blocks up to the last
  row (so a bad Adler-32 or trailing junk is seen only where zlib reaches
  it before stopping);
- JPEG through the host library's decoder (``utils/jpeg.py``,
  ``csrc/jpeg_decode.cpp``): baseline, extended and progressive Huffman
  frames and sequential and progressive arithmetic-coded ones with 8-bit
  samples, grey, YCbCr, RGB, CMYK or YCCK (a 4-component file as PIL's
  mode ``CMYK``, its samples inverted), any integral sampling factors,
  restart intervals, computed as libjpeg-turbo computes them (its SIMD
  IDCT's 16-bit wrapping included); damaged as PIL reads it: PIL's own walk of
  the markers before the first scan (a frame of other than 8 bits is
  None), libjpeg's checks of each segment, its standard Huffman tables
  where a sequential file leaves one undefined, and its end of data (a
  single-scan file may end without EOI where libjpeg's bit buffer, fed as
  PIL feeds it, never runs dry; an arithmetic-coded scan that needs a
  byte past the 64 KiB blocks PIL has fed is None, as libjpeg's
  arithmetic decoder cannot wait for more);
- WebP through the host library's decoder (``utils/webp.py``,
  ``csrc/webp_decode.cpp``): VP8L, VP8 key frames, ALPH and an
  animation's first frame on its canvas, as libwebp's ``WebPAnimDecoder``
  gives them to PIL (RGBA not premultiplied, fancy upsampling; RGB where
  the file has no alpha), its demuxer's checks of every chunk and frame
  included;
- BMP and DIB (a BMP without its file header, its pixels where PIL's
  reads of the header, masks and palette end): ``BI_RGB`` at 1, 4, 8, 16,
  24 and 32 bits (the fourth byte of a 32-bit pixel ignored, as PIL
  ignores it) and ``BI_BITFIELDS`` at 16, 24 and 32 bits with the masks
  PIL reads, bottom-up or top-down; RLE8 and RLE4 as PIL's
  BmpRleDecoder reads them (the host library, ``utils/codecs.py``): its
  four-byte delta, runs cut at the row's end, absolute runs of RLE4 that
  drop an odd count's last index, word alignment by the file offset, a
  grey palette read as the indices themselves (mode ``L``);
- TGA: image types 1, 2, 3, 9, 10 and 11 (colour-mapped, true-colour,
  grey, and their run-length forms) at 8, 24 and 32 bits, with the origin
  bits; a run packet that crosses a row is PIL's "buffer overrun"; grey
  at 1 bit (mode ``1``, rows padded to a byte; run-length or with a
  colour map None, as PIL fails on both);
- binary PNM: P4 (mode ``1``, a set bit black), P5 and P6 at every maxval
  (255 as the bytes, any other through PpmDecoder's float64 scaling,
  half to even; a 16-bit P6 scaled to 255), Pf (mode ``F``: its scale's
  sign the byte order, rows bottom-up);
- GIF (87a and 89a), the first frame: LZW in the host library
  (``utils/codecs.py``, ``csrc/lzw_decode.cpp``), the local or global
  colour table (entries past it black) or none (grey), the graphic
  control extension's transparency, interlaced rows, a frame inside or
  past the logical screen (the rest index 0, or the transparent one);
- TIFF, the first IFD of a classic file in either byte order or of a
  little-endian BigTIFF (its 16-byte header, 8-byte entry counts and
  offsets, values of up to 8 bytes inline, LONG8 strip and tile
  offsets; PIL takes a BigTIFF by the header's third byte, so it reads a
  big-endian one as a classic file), as PIL
  (with libtiff for compressed data, which opens the file itself, BigTIFF
  or classic by its version, and lays the data out by its own reading
  of the IFD) reads it: the entries that fit in the file, up to a tag
  whose values lie past its end (PIL stops there; libtiff skips the tag
  alone, or fails where it fetches the tag without recovery), a one-value
  tag with more values read by PIL as its first and failing libtiff's
  reading where libtiff fetches it without recovery, as do no values, a
  planar configuration other than 1 or 2, 0 rows a strip and an extra
  sample kind past 2; libtiff's row of a strip or tile held to the row
  PIL's unpacker reads (where a damaged IFD makes the two read it apart);
  PIL's raw decoder's tiles for uncompressed data (the last offset of a
  strip or tile that covers the image, every other offset a tile of the
  next cell, in the offsets' order);
  no compression, LZW
  (host library), Deflate (``zlib``), PackBits (host library), LZMA
  (Python's ``lzma`` over the xz stream, read until the strip is full as
  libtiff's LZMADecode reads it: what liblzma finds wrong after that byte
  is not seen) and ZSTD (the host library's ``csrc/zstd_decode.cpp``,
  libzstd's streaming decoder as libtiff drives it: the first frame, cut
  at the strip's end); predictor 2 at 8, 16 and 32 bits for LZW,
  Deflate, LZMA and ZSTD, the codecs libtiff runs it in (a ``cumsum`` in
  the sample's unsigned dtype), and predictor 3 there on 32-bit floats
  (libtiff's ``fpAcc``: each row's bytes summed a pixel apart, then its
  byte planes gathered, the most significant first); predictor 3 on
  integers, predictor 2 at other than 8, 16, 32 or 64 bits and predictor
  values other than 1-3 fail libtiff's ``PredictorSetup``, so the file is
  None; CCITT Modified Huffman,
  Group 3 (1-D, or 2-D by T4Options bit 0, EOLs aligned or not) and
  Group 4 (host library, ``codecs.Fax``: libtiff 4.7's decoder, its
  recovery from bad code words, rows too long or too short and data that
  ends early, the strip read again without EOLs, PIL's strip buffer kept
  between strips); JPEG (compression 7: each strip or tile the host
  library's JPEG decoder reads as libtiff's JPEG codec hands libjpeg's
  samples to PIL, ``jpeg.TiffDecoder``: after the JPEGTables and the
  tables of the streams before it, libtiff's checks of each stream,
  YCbCr converted to RGB by libjpeg at the stream's sampling (the
  YCbCrSubsampling tag, or without it the first strip's), other
  photometrics' samples as stored, CMYK not inverted, grey + alpha as
  two components); the image turned
  by its Orientation tag as PIL's ``load_end`` turns it
  (``ImageOps.exif_transpose``);
  strips or tiles, contiguous or separate planes (uncompressed 16-bit
  ones as PIL reads them: see below); photometric 0, 1, 2 and
  3 at 1, 2, 4, 8 and 16 bits, 12-bit grey (PIL's ``I;12``, min-is-black
  and little-endian only: the samples' bits most significant first, each
  row ending on a byte), grey + alpha, RGB with extra samples 0, 1
  (associated alpha, unpremultiplied as PIL's ``RGBa`` with its
  truncation) and 2, palette + alpha; 32-bit floats (mode ``F``,
  truncated and clipped to 0..255 as PIL converts them); mode ``I``
  (32-bit signed, 32-bit unsigned little-endian, 16-bit signed; clipped
  to 0..255), a compressed big-endian one or float read with its bytes
  swapped, as PIL reads libtiff's native samples; CMYK at 8 bits with 0,
  1 or 2 extra samples and at 16 (PIL's ``cmyk2rgb``); YCbCr: compressed
  at subsampling (1, 1) through libtiff 4.7's RGBA reader (its
  ``TIFFYCbCrToRGBInit`` tables under the file's YCbCrCoefficients and
  ReferenceBlackWhite), uncompressed raw as PIL reads it (4 bytes a pixel
  as RGB, or the planes as R, G and B); fill order 2;
- PSD, the merged image PIL shows before any ``seek``: raw or RLE
  (PackBits rows, as PIL's decoder drops what a packet holds past a row),
  bitmap (a set bit white, as PIL reads it), grey, multichannel and
  duotone (the first channel), indexed, RGB (a 4th channel is alpha) and
  CMYK (stored inverted, PIL's ``cmyk2rgb``) at 8 bits;
- SGI: the 8 modes of PIL's table (L, RGB and RGBA at 1 or 2 bytes a
  sample, the high byte kept as PIL keeps it), verbatim or RLE (the host
  library's expansion, ``utils/codecs.py``, as PIL's SgiRleDecode.c
  expands the rows: a row that ends early keeps the previous row's
  samples, a row whose last packet is not the end stops the decoding
  without an error, the rows after it black);
- PCX: 1 bit in 1 plane, 1 bit in 2 or 4 planes with the header's 16
  colours, and version 5 at 8 bits in 1 plane (grey, or the palette after
  ``0x0C`` at the end where it is not the grey ramp) or 3 (RGB), PIL's
  stride rule and its moving of the planes included; the RLE lines in the
  host library;
- IM, the first frame of each mode PIL's IM writer makes: ``0 1``,
  Greyscale, LA (both with a ``Lut`` that is not grey: PIL's ``P`` and
  ``PA``), ``L 32S`` (``I``, clipped to 0..255), ``L 16``, ``L 16L`` and
  ``L 16B``, ``L 32F`` (``F``), RGB, RGBA, RGBX, CMYK (PIL's
  ``cmyk2rgb``) and YCC (PIL's fixed-point ``ImagingConvertYCbCr2RGB``),
  and the type names PIL reads as the same mode and rawmode;
- QOI, as PIL's own Python decoder reads it, not as qoi.h (the host
  library, ``csrc/qoi.cpp``): RGB where the channels byte is 3, else
  RGBA; the index read as zeros before it is filled, a run not stored in
  it, a run past the last pixel and a missing end marker allowed;
- DDS: uncompressed RGB and RGBA under any masks and bit count (PIL's
  ``DdsRgbDecoder``, bytes past the file's end read as zeros), L and LA
  luminance, 8-bit indices with an RGBA palette, and BC1 (DXT1), BC2
  (DXT3), BC3 (DXT5), BC4 (BC4U, ATI1), BC5 (BC5U, ATI2) and BC5S blocks
  (the host library, ``csrc/bcn_decode.cpp``, as PIL's BcnDecode.c) or,
  after a DX10 header, those, BC6H (UF16 and SF16, as RGB), BC7 (typeless,
  UNORM and UNORM_SRGB, whose gamma is not applied) and 8-bit RGBA by
  their DXGI formats;
- ICO: the frame ``IcoFile`` puts first (the largest, and of two as large
  the one of fewer bits), a PNG decoded as above from its offset on, its
  ``tRNS`` unapplied (PIL's ICO image takes the frame's pixels and
  palette, not its ``info``), or a DIB read as above at half its height,
  its alpha the 1-bit AND mask (read from the end of the entry's
  resource) or, where the entry has 32 bits, every fourth byte;
- CUR: the cursor PIL picks (one whose width and height are both larger
  replaces the one kept), its bitmap read as above at half its height,
  no mask; a 32-bit bitmap at byte 22 (a one-entry file) keeps its
  alpha;
- JPEG 2000, a JP2 file or a bare codestream, through the host library's
  decoder (``utils/jpeg2000.py``, ``csrc/j2k_decode.cpp``): every file
  PIL writes from L, LA, RGB and RGBA under its save options but the
  cinema profiles (the 5/3 or 9/7 transform, quality layers, the five
  progression orders, precincts, code-block sizes, tiles, image and tile
  offsets, RCT or ICT, signed samples, PLT markers), as OpenJPEG 2.5.4
  decodes it for PIL; PIL's header checks, then OpenJPEG's strict
  reading (a cut file is broken, apart from a cut just after a tile's
  SOT marker code, which PIL gives with the tiles before it decoded and
  zeros after);
- ICNS: the entries of the largest size ``IcnsFile.bestsize`` finds
  (``ic10``, 1024x1024, in the files PIL and the port write): a PNG
  (``tRNS`` unapplied as for ICO) or a JPEG 2000 stream of the entry's
  length (as above), else the 24-bit RGB of ``is32``, ``il32``, ``ih32``
  or ``it32`` (uncompressed at exactly three planes, else PIL's
  run-length planes, the host library) with its 8-bit mask as alpha;
  the size held as PIL's ``size`` setter holds it;
- BLP, as PIL's BLP plugin reads the first mipmap: BLP1 palette images
  (the indices straight after the palette) and JPEG images (the JPEG
  decoder above over the stored header and the mipmap, a 4-component
  stream in libjpeg's CMYK colour space whatever its Adobe marker says,
  red and blue swapped), BLP2 palette images and DXT1, DXT3 and DXT5
  blocks as PIL's own Python decoders compute them (the host library,
  not BcnDecode.c's rule), each laid out as PIL's ``set_as_raw`` lays
  its bytes out at the header's width and mode;
- FTEX: DXT1 (BcnDecode.c's BC1, RGBA) or raw RGB, the first mipmap;
- the formats PIL reads through its raw decoder (``utils/rasters.py``,
  host numpy): FITS (BITPIX 8, 16, 32, -32 and -64 at NAXIS 1, 2 or 3,
  the samples at the byte order PIL reads them in, not the standard's;
  ``GZIP_1`` tile compression as PIL's ``FitsGzipDecoder``), McIDAS
  (1, 2 and 4 bytes an element, PIL's offset and line stride), SPIDER
  (float32 in either byte order, a stack's first image), PIXAR (RGB),
  IMT, XV thumbnails (PIL's 3-3-2 palette) and DCX (the first page, a
  PCX read as above), each laid out as PIL's ``ImageFile.load`` lays a
  raw tile out for a file opened by its path (memory-mapped where it
  maps the mode);
- the X11 and Sun workstation bitmaps (``utils/bitmaps.py``, host
  numpy): Sun rasters (depth 1, 4, 8, 24 and 32, raw rows or PIL's
  ``sun_rle``, planar colour maps), GIMP brushes (versions 1 and 2,
  depth 1 and 4), MSP (``DanM`` raw and ``LinS`` run-length), XBM (PIL's
  decoder, which reads the two bytes after each ``x``) and XPM (``P``
  and ``RGB``, hex colours, the transparency key as PIL's palette
  alphas), each as its plugin and PIL's C decoders read it;
- FLI/FLC, Kodak PhotoCD and IPTC/NAA (``utils/fli_pcd_iptc.py``): an
  animation's first frame (SS2, LC, BLACK, BRUN and COPY chunks, the host
  library's ``csrc/fli_decode.cpp``) through its first colour chunk's
  palette, PhotoCD's 768x512 base image (PhotoYCC by PIL's tables, turned
  by its orientation), and an IPTC record's raw or "jpeg" image (the
  latter any file decoded here), in one band of ``RGB`` or ``CMYK`` where
  the record names one.

Four named deviations from PIL, one rule: a 16-bit grey PNG (colour type
0), a 16-bit grey TIFF, a 16-bit grey IM file (``L 16``, ``L 16L``,
``L 16B``) and a P5 PNM with a maxval above 255 keep the high byte of
each sample (the P5's scaled to 65535 as PIL scales it), as stb_image
(the reference's loader) and PIL's own 16-bit RGB paths do (the PNG's
``tRNS`` key is compared with the 16-bit sample); so do the samples PIL
reads as ``I;16`` or ``I;16B`` from a FITS file (BITPIX 16, ZBITPIX 16)
and a 2-byte McIDAS file, the high byte of the sample as PIL unpacks it;
and a 12-bit grey TIFF keeps the top 8 bits of each sample (``v >> 4``,
a 12-bit map's high byte).
PIL opens the first three and the 12-bit TIFF as mode ``I;16``
(``I;16L``, ``I;16B``) and the
P5 as mode ``I``, and ``convert("RGBA")`` clips at 255 instead, so in the
JAX package a 16-bit roughness map comes out almost all 1.0.

Copied, not fixed: an uncompressed TIFF of separate 16-bit planes (RGB,
RGBA, CMYK) reads as PIL reads it, each strip or tile through PIL's raw
decoder under one letter of the raw mode (``RGB;16L``'s ``R``, ``G``,
``B``) as its plane's raw mode: each plane's bytes as 8-bit samples, a
row's second half in the row below, rows a tile's width apart (past the
image's right edge, PIL's stride); under a letter that is no band
(``RGBX;16L``'s ``X``, ``RGBa;16L``'s ``a``) the file is None.

A missing file, a file no PIL plugin opens (an HTML page saved as
``.png``, zeros, noise), and a broken file of a format decoded here (a
bad checksum, truncated data, a header or mode PIL refuses, more pixels
than PIL's decompression-bomb limit) return ``None``, as PIL's exception
does in the JAX package and as the reference's ``Image`` fails soft to
black (image.cpp:48-49). So do BUFR, GRIB, HDF5 and MPEG files, which
PIL opens and never decodes on any host (stubs whose loader only an
application's handler fills, and MPEG with no tile). A format PIL opens
and the port does not (AVIF, EPS (PIL reads it only through
Ghostscript) and WMF (only on Windows): the other 3 plugins) or a
flavour of one decoded here that it does not take (lossless and block-smoothed progressive
JPEG, an uncompressed BMP or DIB whose grey palette PIL reads at
another sample size than the pixels' (1 or 4 bits as ``L``, 8 bits under
two entries as ``1``), plain-text PNM (P1-P3) and PIL's test extensions
(``P0CMYK``, ``PyP``, ``PyRGBA``, ``PyCMYK``), old-style JPEG-in-TIFF
(compression 6), JPEG-in-TIFF in separate planes, CCITT RLEW (32771),
YCbCr TIFF at other subsampling than (1, 1) or turned by its orientation
(JPEG-compressed YCbCr apart), uncompressed YCbCr TIFF tiles, CIELab
TIFF, old-style LZW, 12-bit JPEG-in-TIFF, CIELab PSD, the IM image types PIL's
writer does not make, JPEG 2000 (in an ICNS entry too)
with tile-parts, code-block styles, SOP or EPH markers, COC, QCC, RGN,
POC, PPM or PPT markers, samples of other than 8 bits, subsampled
components, a colour space other than grey or sRGB, a palette or
reordered channels, a BLP1 JPEG of a refused JPEG flavour, ...) raises
``NotImplementedError`` naming the file and the flavour: a texture is
never dropped quietly.

Named deviations on damaged or odd files (``tests/test_torch_damage.py``
and ``tests/test_torch_formats.py`` hold the rest):

- a refused flavour raises first, also where PIL would then fail on the
  file: a lossless frame made by a damaged marker;
- where a plugin's prefix test passes and its ``_open`` then fails, PIL
  goes on to the next plugin; the port follows it only for the first
  checks of ICO, PCX and WMF, for all of CUR's (its pick of
  a cursor, the reads of its bitmap header, a size of no pixels:
  ``_OPEN_CHECKS``; a TGA starts with CUR's bytes), BLP's and MPEG's
  (their header reads, a size of no pixels), FTEX's (its reads up to the
  mipmap's length) and IM's (a plugin without a prefix test); it follows
  the whole
  ``_open`` of DCX (its directory and the page's PCX header), FITS,
  MCIDAS, PIXAR and XVTHUMB, and of IMT and SPIDER, which have no prefix
  test (``utils/rasters.py``), of GBR, MSP, SUN, XBM and XPM
  (``utils/bitmaps.py``: a C header that starts ``#define`` is None, as
  in PIL), and of FLI, and of IPTC and PCD, which have no prefix test
  (``utils/fli_pcd_iptc.py``);
- a McIDAS file whose line stride is shorter than a line, which PIL
  memory-maps for ``L`` and ``I;16B``: the last lines' bytes past the
  file's end read as zeros, as the map's last page holds them; where they
  run past that page PIL reads memory the map does not hold (its image
  differs from run to run, or the process faults), and the port refuses
  the file;
- a TIFF damaged inside its IFD (an entry's tag, type, count or value):
  PIL's and libtiff's checks of each entry are copied only as far as the
  paragraph on TIFF above says;
- an uncompressed TIFF in one strip at orientation 5-8 that PIL
  memory-maps (its raw mode its mode: L, P, RGBA and CMYK at 8 bits,
  I;16 and I;16B) is refused: PIL maps its samples at the size it has
  already swapped, so its pixels are the rows read at the wrong width;
- CCITT data that ends before the last row of a strip or tile (Group 4
  stops there without an error) leaves the rows after it as PIL's strip
  buffer held them: the strip's before, which is read, or, in the first
  strip, memory PIL never initialised (its image differs from run to
  run), which is refused; a JPEG stream smaller than its strip or tile,
  which libtiff reads with a warning, leaving the rest of the buffer as
  it was, is refused;
- a JPEG 2000 tile whose packet headers are damaged: OpenJPEG's checks
  of a packet are copied as far as its code-block segments (one past the
  tile's end is broken, header bits past it read as zeros); a zero
  bit-plane count over 64 is broken here, and a JP2 header whose size or
  component count is not the codestream's is refused;
- a compressed YCbCr TIFF (JPEG apart) whose strip fails to decode is
  None here; PIL reads it through libtiff's RGBA reader, which it starts
  with ``stoponerr`` 0, so libtiff goes on past the failed strip with
  whatever its strip buffer holds;
- a ZSTD strip whose damaged match reaches past the window into
  libzstd's ring buffer after it has wrapped (a frame longer than the
  window and two blocks) reads the frame's own bytes here, whatever the
  ring buffer holds in libzstd; a legacy (pre-1.0) zstd frame is broken
  here; ``tools/zstd_sweep.py`` holds every other cut and flip.

Writing: :func:`write_image` is what the viewer, the CLI and the shell
save through. As the JAX package's ``PIL.Image.save(path)``, it picks the
format from the lower-cased extension against PIL 12.1's registered
extensions and writes PIL's file at its defaults for uint8 grey (mode
``L``) or RGB pixels:

==============================  =========================================
extension                       what is written
==============================  =========================================
``.png``, ``.apng``             :func:`write_png` (8 bits, filter 0): the
                                decoded pixels equal PIL's file
``.jpg .jpeg .jpe .jfif``       PIL's JPEG byte for byte (quality 75,
                                4:2:0 for RGB, libjpeg-turbo's arithmetic:
                                ``utils/jpeg.py``, ``csrc/jpeg_encode.cpp``)
``.bmp``, ``.dib``              PIL's BMP / DIB byte for byte
``.tif``, ``.tiff``             PIL's uncompressed TIFF byte for byte
``.pbm .pgm .ppm .pnm .pfm``    PIL's P5 (L) / P6 (RGB) byte for byte
``.tga .icb .vda .vst``         PIL's uncompressed TGA byte for byte
``.gif``                        PIL's GIF byte for byte (L: the used grey
                                levels as the palette; RGB: PIL's median
                                cut; LZW, interlaced from 16 pixels:
                                ``utils/gif.py``, ``csrc/gif_encode.cpp``)
``.im``                         PIL's IM byte for byte (the header holds
                                the file's name, as PIL writes it)
``.sgi .bw .rgb .rgba``         PIL's uncompressed SGI byte for byte (the
                                header holds the file's stem)
``.pcx``                        PIL's PCX byte for byte (RLE rows; L with
                                the grey palette)
``.webp``                       PIL's WebP byte for byte (libwebp's lossy
                                VP8 at quality 80, method 4; L as RGB:
                                ``utils/webp.py``, ``csrc/webp_encode.cpp``)
``.qoi``                        PIL's QOI byte for byte (RGB; colorspace
                                byte 1; ``csrc/qoi.cpp``)
``.dds``                        PIL's uncompressed DDS byte for byte (L as
                                LUMINANCE, RGB as BGR)
``.eps``, ``.ps``               PIL's EPS byte for byte (hex samples)
``.mpo``                        PIL's single-frame MPO: its JPEG, byte for
                                byte
``.pdf``                        PIL's PDF byte for byte (the JPEG as
                                ``/DCTDecode``; the title the file's stem,
                                the dates ``time.gmtime()``'s)
``.ico``                        PIL's directory; each frame (PIL's LANCZOS
                                thumbnail into 16 ... 256, where it fits)
                                a PNG of PIL's pixels
``.icns``                       PIL's directory; each entry (PIL's BICUBIC
                                resize to 32 ... 1024) a PNG of PIL's
                                pixels
``.j2c .j2k .jp2 .jpc .jpf      PIL's JPEG 2000 byte for byte (OpenJPEG
.jpx``                          2.5.4's lossless 5/3 codestream; bare for a
                                name ending in ``.j2k``, else in a JP2
                                file: ``utils/jpeg2000.py``,
                                ``csrc/j2k_encode.cpp``)
the 27 extensions PIL cannot    PIL's exception and message: ``KeyError``
save as L or RGB, and ``.qoi``  without a save handler (``.psd``, ``.xpm``
for L                           ...), ``OSError`` for a handler not
                                installed or a mode refused (``.bufr``,
                                ``.msp`` ...), ``ValueError`` (``.blp``,
                                ``.qoi``)
the 2 other extensions PIL      ``NotImplementedError`` naming the path
knows (``.avif .avifs``)        and the format
an unknown extension, or none   ``ValueError("unknown file extension")``
==============================  =========================================

Sampling on the device is ``ops/texturing.py``; :func:`sample_nearest` is
the host ``tex2D`` for tests and tools.
"""

from __future__ import annotations

import lzma
import math
import os
import re
import struct
import time
import zlib

import numpy as np

from . import (bitmaps, codecs, fli_pcd_iptc, gif, jpeg, jpeg2000, rasters,
               resample, webp)

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}


class _Unreadable(Exception):
    """The file is of a format decoded here, but broken: fail soft like
    the reference (PIL raises on it)."""


class _Refused(Exception):
    """A flavour of a format decoded here that this decoder does not
    take."""


def _check_size(width: int, height: int) -> None:
    """Image.open's decompression-bomb check: PIL raises past twice
    ``Image.MAX_IMAGE_PIXELS`` (89,478,485) pixels."""
    if max(1, width) * max(1, height) > 2 * 89478485:
        raise _Unreadable(f"{width}x{height} pixels (a decompression bomb)")


def load_rgba(path: str) -> "np.ndarray | None":
    """Load an image file as float32 RGBA [H, W, 4] in [0, 1] (row 0 =
    image top), equal to PIL's ``convert("RGBA")`` / 255 (see the module
    docstring for the formats and the four deviations). ``None`` when the
    file is missing or broken; ``NotImplementedError`` naming the file and
    the format for a format or flavour not decoded here."""
    rgba = load_rgba8(path)
    return None if rgba is None else rgba.astype(np.float32) / 255.0


def load_rgba8(path: str) -> "np.ndarray | None":
    """:func:`load_rgba` as uint8 [H, W, 4]: PIL's ``convert("RGBA")``
    itself."""
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    kind = _sniff(data)
    if kind is None or kind in _NO_DECODER:   # not an image, or one that
        return None                           # PIL never decodes
    if kind not in _DECODERS:
        raise NotImplementedError(
            f"{path}: {kind} is not decoded by the PyTorch port (PNG, JPEG, "
            "BMP, DIB, TGA, binary PNM and PFM, GIF, TIFF, PSD, WebP, SGI, "
            "PCX, DCX, IM, QOI, DDS, ICO, CUR, ICNS, JPEG 2000, BLP, FTEX, "
            "FITS, McIDAS, SPIDER, PIXAR, IMT, XV thumbnails, Sun raster, "
            "GBR, MSP, XBM, XPM, FLI/FLC, PhotoCD and IPTC are; convert it; "
            "ROADMAP Queue 1 item 11)")
    try:
        return _DECODERS[kind](data)
    except (_Refused, NotImplementedError) as e:
        raise NotImplementedError(
            f"{path}: {kind} ({e}) is not decoded by the PyTorch port "
            "(ROADMAP Queue 1 item 11)") from None
    except (_Unreadable, jpeg.BrokenJpeg, webp.BrokenWebP,
            jpeg2000.BrokenJpeg2000, zlib.error,
            struct.error, ValueError, IndexError, KeyError, TypeError):
        return None


# ---- which format PIL opens a file as --------------------------------------

def _i16be(d: bytes) -> int:
    return d[0] << 8 | d[1] if len(d) >= 2 else -1


def _i32(d: bytes, order: str = "<") -> int:
    return struct.unpack_from(order + "I", d)[0] if len(d) >= 4 else -1


_IM_TAGS = (b"Comment", b"Date", b"Digitalization equipment",
            b"File size (no of images)", b"Lut", b"Name", b"Scale (x,y)",
            b"Image size (x*y)", b"Image type")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _im_header(d: bytes) -> bool:
    """ImImagePlugin._open: ``Key: value`` lines of at most 100 bytes up
    to a NUL, a ^Z or the end, one or more of its keys known."""
    if b"\n" not in d[:100]:
        return False
    pos, known = 0, 0
    while pos < len(d):
        if d[pos] == 13:            # a CR at a line's start is skipped
            pos += 1
            continue
        if d[pos] in (0, 26):
            break
        end = d.find(b"\n", pos)
        end = len(d) if end < 0 else end + 1
        line = d[pos:end]
        pos = end
        if len(line) > 100:
            return False
        m = _IM_LINE.match(line.rstrip(b"\n").removesuffix(b"\r"))
        if not m:
            return False
        known += m.group(1) in _IM_TAGS
    return known > 0


def _tga_header(d: bytes) -> bool:
    """TgaImagePlugin._open's header check (TGA has no leading bytes)."""
    return (len(d) >= 18 and d[1] in (0, 1) and d[16] in (1, 8, 16, 24, 32)
            and _u16(d, 12) > 0 and _u16(d, 14) > 0)


# PIL 12.1's 43 plugins in the order Image.open tries them (Image.preinit's
# BMP, DIB, GIF, JPEG, PPM and PNG, then the rest as Image.init registers
# them), each with its _accept test on the first 16 bytes or, for the six
# without one (IM, IMT, IPTC, PCD, SPIDER, TGA), the header check its
# _open starts with
_PIL_OPENS = (
    ("BMP", lambda p: p.startswith(b"BM")),
    ("DIB", lambda p: _i32(p) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a"))),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff")),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy"),
    ("PNG", lambda p: p.startswith(_SIGNATURE)),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2"))),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0")),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)),
    ("DCX", lambda p: _i32(p) == 0x3ADE68B1),
    ("DDS", lambda p: p.startswith(b"DDS ")),
    ("EPS", lambda p: p.startswith(b"%!PS") or _i32(p) == 0xC6D3D0C5),
    ("FITS", lambda p: p.startswith(b"SIMPLE")),
    ("FLI", lambda p: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12)
     and _u16(p, 14) in (0, 3)),
    ("FTEX", lambda p: p.startswith(b"FTEX")),
    ("GBR", lambda p: len(p) >= 8 and _i32(p, ">") >= 20
     and _i32(p[4:], ">") in (1, 2)),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", lambda p: p.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", lambda p: p.startswith(b"icns")),
    ("ICO", lambda p: p.startswith(b"\0\0\1\0")),
    ("IM", None), ("IMT", None),
    ("IPTC", None),
    ("MCIDAS", lambda p: p.startswith(b"\0\0\0\0\0\0\0\4")),
    ("MPEG", lambda p: p.startswith(b"\0\0\1\xb3")),
    ("TIFF", lambda p: p.startswith((
        b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
        b"MM\x00\x2b", b"II\x2b\x00"))),
    ("MSP", lambda p: p.startswith((b"DanM", b"LinS"))),
    ("PCD", None),
    ("PIXAR", lambda p: p.startswith(b"\200\350\000\000")),
    ("PSD", lambda p: p.startswith(b"8BPS")),
    ("QOI", lambda p: p.startswith(b"qoif")),
    ("SGI", lambda p: _i16be(p) == 474),
    ("SPIDER", None),
    ("SUN", lambda p: _i32(p, ">") == 0x59A66A95),
    ("TGA", None),
    ("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP"
     and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                    b"\x01\x00\x00\x00"))),
    ("XBM", lambda p: p.lstrip().startswith(b"#define")),
    ("XPM", lambda p: p.startswith(b"/* XPM */")),
    ("XVTHUMB", lambda p: p.startswith(b"P7 332")),
)
_HEADER_CHECKS = {
    "IM": _im_header, "TGA": _tga_header, **rasters.HEADER_CHECKS,
    # IPTC and PCD: their whole _open (``utils/fli_pcd_iptc.py``)
    **fli_pcd_iptc.HEADER_CHECKS,
}


# the first checks of the _open of plugins whose _accept a file of another
# format passes (a TGA starts 00 00 02 00, CUR's prefix): where they fail,
# PIL goes on to the next plugin
_OPEN_CHECKS = {
    # CurImagePlugin: a cursor and its bitmap header; IcoImagePlugin: one
    # directory entry or more
    "CUR": lambda d: len(d) >= 6 and _cur_entry(d) is not None,
    "ICO": lambda d: len(d) >= 22 and len(d) >= 6 + 16 * _u16(d, 4) > 6,
    # PcxImagePlugin: a bounding box with area
    "PCX": lambda d: len(d) >= 12 and _u16(d, 8) + 1 > _u16(d, 4)
    and _u16(d, 10) + 1 > _u16(d, 6),
    # WmfImagePlugin: an EMF signature after the 01 00 00 00 prefix
    "WMF": lambda d: d.startswith(b"\xd7\xcd\xc6\x9a") or d[40:44] == b" EMF",
    # BlpImagePlugin: the header's reads (a BLP1 file's to its encoding, a
    # BLP2 file's to its size) and a size with pixels
    "BLP": lambda d: len(d) >= (24 if d.startswith(b"BLP1") else 20)
    and _u32(d, 12) > 0 and _u32(d, 16) > 0,
    "FTEX": lambda d: _ftex_opens(d),
    # MpegImagePlugin: the 12-bit width and height after the start code,
    # both more than 0
    "MPEG": lambda d: len(d) >= 7 and d[4] << 4 | d[5] >> 4 > 0
    and (d[5] & 15) << 8 | d[6] > 0,
    # DCX, FITS, MCIDAS, PIXAR and XVTHUMB: their whole _open
    # (``utils/rasters.py``)
    **rasters.OPEN_CHECKS,
    # GBR, MSP, SUN, XBM and XPM: their whole _open (``utils/bitmaps.py``)
    **bitmaps.OPEN_CHECKS,
    # FLI: its whole _open (``utils/fli_pcd_iptc.py``)
    **fli_pcd_iptc.OPEN_CHECKS,
}


def _sniff(data: bytes) -> "str | None":
    """The format PIL 12.1 opens the file as, by the same tests in the same
    order, or None where none passes (PIL: "cannot identify image file").
    Where PIL's test passes and its plugin then fails, PIL tries the next
    plugin; the port follows it for the first checks of ``_OPEN_CHECKS``
    only (see the module docstring)."""
    prefix = data[:16]
    for name, accept in _PIL_OPENS:
        if (_HEADER_CHECKS[name](data) if accept is None
                else accept(prefix)) and _OPEN_CHECKS.get(
                    name, lambda d: True)(data):
            return name
    return None


_CHUNK_TYPE = re.compile(rb"\w\w\w\w")


def _png_chunks(data: bytes):
    """The chunks PngImagePlugin reads: ``(kind, body)`` of each chunk
    before the first IDAT, its CRC checked after its handler, then
    ``(b"IDAT", data)`` of the run of IDAT chunks that follows, their CRCs
    unchecked, each body as far as the file holds it, and where PIL stops
    reading them; nothing after (PIL skips the chunks that follow the
    image data with their CRCs, and needs no IEND)."""
    pos = len(_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise _Unreadable("truncated chunk header")
        length, kind = struct.unpack_from(">I4s", data, pos)
        if not _CHUNK_TYPE.match(kind):
            raise _Unreadable(f"broken chunk type {kind!r}")
        if kind == b"IEND":
            raise _Unreadable("no image data")
        if kind == b"IDAT":
            break
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length:
            raise _Unreadable("truncated chunk")
        yield kind, body
        if len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(
                ">I", crc)[0]:
            raise _Unreadable(f"bad CRC in {kind!r}")
        pos += 12 + length
    idat = []
    while True:                   # PngImageFile.load_read
        idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length        # past the CRC, unread
        head = data[pos:pos + 8]  # (a header PIL cannot read ends the
        if len(head) < 8 or head[4:] != b"IDAT":    # run too: an error
            yield b"IDAT", idat                  # only if rows are missing)
            return
        length = struct.unpack(">I", head[:4])[0]


def _inflate(chunks, need: int) -> bytes:
    """The first ``need`` bytes of the zlib stream in the IDAT ``chunks``,
    as PIL's ZIP decoder inflates them: fed a chunk at a time in blocks of
    at most 64 KiB, it stops in the call that fills the last row, so an
    error (a bad code, the Adler-32 checksum) is seen only where zlib
    reaches it without writing another byte; what follows goes unread."""
    z = zlib.decompressobj()
    out, n = [], 0
    for chunk in chunks:
        for at in range(0, len(chunk), 65536):
            out.append(z.decompress(chunk[at:at + 65536], need - n))
            n += len(out[-1])
            if n == need:
                return b"".join(out)
    raise _Unreadable("truncated image data")


# Adam7: (x start, y start, x step, y step) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _decode_png(data: bytes, transparency: bool = True) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a PNG file's bytes; ``transparency=False``
    leaves a ``tRNS`` chunk unapplied, as PIL's ICO and ICNS readers do
    (they take the frame's pixels and palette, not its ``info``)."""
    header, palette, trns, idat = None, None, None, None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            if len(body) < 13:
                raise _Unreadable("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat = body
    if header is None:
        raise _Unreadable("no IHDR chunk")
    width, height, depth, colour, _, filt, interlace = header
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1]:
        raise _Unreadable(f"colour type {colour} with bit depth {depth}")
    if filt != 0 or width == 0 or height == 0:
        raise _Unreadable("bad header")
    _check_size(width, height)
    if colour == 3 and palette is None:
        raise _Unreadable("palette image without PLTE")
    spp = _COLOUR_TYPES[colour][0]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)  # any nonzero: Adam7
    sizes = [(-(-(width - x0) // dx), -(-(height - y0) // dy))
             for x0, y0, dx, dy in passes]
    need = sum(h * ((w * spp * depth + 7) // 8 + 1) for w, h in sizes
               if w > 0 and h > 0)
    raw = _inflate(idat, need)
    if not interlace:
        samples, _ = _pass_samples(raw, 0, width, height, spp, depth)
    else:
        samples = np.zeros((height, width, spp),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for (x0, y0, dx, dy), (w, h) in zip(_ADAM7, sizes):
            if w > 0 and h > 0:         # an empty pass has no filter bytes
                sub, pos = _pass_samples(raw, pos, w, h, spp, depth)
                samples[y0::dy, x0::dx] = sub
    return _to_rgba(samples, colour, depth, palette,
                    trns if transparency else None)


def _pass_samples(raw: bytes, pos: int, width: int, height: int, spp: int,
                  depth: int):
    """[H, W, spp] samples (uint16 at 16 bits) of the filtered rows of one
    image or Adam7 pass starting at ``raw[pos]``, and where it ends."""
    bits = spp * depth
    stride = (width * bits + 7) // 8
    end = pos + height * (stride + 1)
    if len(raw) < end:
        raise _Unreadable("truncated image data")
    rows = _unfilter(raw[pos:end], height, stride, max(1, bits // 8))
    if depth < 8:
        samples = _unpack(rows, depth, width)[..., None]
    elif depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    else:
        samples = rows
    return samples.reshape(height, width, spp), end


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(
                kind, line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise _Unreadable(f"filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_sequential(kind: int, line: bytes, prev: bytes,
                         bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on the one ``bpp``
    to its left, so they run byte by byte."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _unpack(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Sub-byte samples (1, 2 or 4 bits, most significant first)."""
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2).astype(np.uint8)


def _to_rgba(samples: np.ndarray, colour: int, depth: int, palette,
             trns) -> np.ndarray:
    """RGBA8 of [H, W, spp] samples as PIL's ``convert("RGBA")`` makes it.
    16-bit samples keep their high byte, as PIL does for colour types 2, 4
    and 6 and stb_image for all; for 16-bit grey (type 0) PIL clips the
    value at 255 instead, and the port deviates from it (see the module
    docstring)."""
    h, w = samples.shape[:2]
    wide = samples
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    out = np.full((h, w, 4), 255, np.uint8)
    if colour == 3:
        n_pal = len(palette) // 3
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:n_pal, :3] = np.frombuffer(palette, np.uint8,
                                        n_pal * 3).reshape(n_pal, 3)
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[samples[..., 0]]
    if colour in (0, 4):
        grey = samples[..., 0]
        if depth < 8:
            grey = (grey * (255 // ((1 << depth) - 1))).astype(np.uint8)
        out[..., :3] = grey[..., None]
        if colour == 4:
            out[..., 3] = samples[..., 1]
        elif trns is not None and len(trns) >= 2:
            # PIL compares the 8-bit grey with the chunk's raw value (a
            # 1-bit image's as 0 or 255); at 16 bits the port compares the
            # 16-bit sample, as stb_image does
            key = struct.unpack(">H", trns[:2])[0]
            if depth == 1:
                key = 255 if key else 0
            value = (wide[..., 0] if depth == 16 else grey).astype(np.int32)
            out[..., 3] = np.where(value == key, 0, 255)
        return out
    out[..., :3] = samples[..., :3]
    if colour == 6:
        out[..., 3] = samples[..., 3]
    elif trns is not None and len(trns) >= 6:
        # PIL compares the 8-bit samples (at 16 bits, the high bytes) with
        # the chunk's raw 16-bit values
        # (in int32: the keys may exceed 255)
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int32)
        match = (samples[..., :3].astype(np.int32) == key).all(-1)
        out[..., 3] = np.where(match, 0, 255)
    return out


# ---- BMP, TGA, PNM: PIL's BmpImagePlugin, TgaImagePlugin, PpmImagePlugin

def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _rows(data: bytes, pos: int, height: int, nbytes: int,
          stride: int) -> np.ndarray:
    """[height, nbytes] uint8: ``height`` rows of ``nbytes`` bytes each,
    ``stride`` apart from ``data[pos]``, as stored."""
    if pos + (height - 1) * stride + nbytes > len(data):
        raise _Unreadable("truncated pixel data")
    buf = np.frombuffer(data, np.uint8, (height - 1) * stride + nbytes, pos)
    return np.lib.stride_tricks.as_strided(
        buf, (height, nbytes), (stride, 1)).copy()


def _rgb15(pix: np.ndarray, green_bits: int) -> np.ndarray:
    """PIL's BGR;15 (5-5-5) and BGR;16 (5-6-5) unpackers: [.., 3] RGB8 of
    little-endian 16-bit pixels."""
    pix = pix.astype(np.int64)
    gmax = (1 << green_bits) - 1
    b = (pix & 31) * 255 // 31
    g = ((pix >> 5) & gmax) * 255 // gmax
    r = ((pix >> (5 + green_bits)) & 31) * 255 // 31
    return np.stack([r, g, b], -1).astype(np.uint8)


# 32-bit BI_BITFIELDS masks PIL reads (r, g, b, a) -> byte order of R, G, B
# and A in the pixel (-1: no alpha)
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0): (2, 1, 0, -1),                 # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0): (3, 2, 1, -1),           # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0): (3, 1, 0, -1),               # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),         # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),         # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),         # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),         # BGAR
    (0, 0, 0, 0): (2, 1, 0, 3),                                 # BGRA
}


def _decode_bmp(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a BMP file, as BmpImagePlugin reads it."""
    return _bitmap(data, 14, _u32(data, 10))[0]


def _decode_dib(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a DIB file (a BMP without its file header),
    as PIL's DibImageFile reads it: the info header at byte 0, the pixels
    where PIL's reads of the header, the masks and the palette end."""
    return _bitmap(data, 0, 0)[0]


def _bitmap_header(data: bytes, start: int):
    """BmpImagePlugin._bitmap's reading of the info header at ``start``
    (and of the three masks after a 40-byte one): (width, height,
    top_down, bits, compression, colours, palette padding, masks, where
    the palette or pixels start). A read past the file's end is
    ``struct.error``, as in PIL (whose ``Image.open`` then tries the next
    plugin); a header PIL rejects is ``_Unreadable`` (its ``OSError``)."""
    hsize = _u32(data, start)
    head = data[start + 4:start + hsize]
    if len(head) != max(hsize - 4, 0):
        raise _Unreadable("truncated header")
    pos = start + hsize           # where the palette (or the masks) start
    masks = None
    if hsize == 12:               # OS/2 BITMAPCOREHEADER
        width, height, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, pad, top_down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = head[7] == 0xFF
        width = _u32(head, 0)
        height = (1 << 32) - _u32(head, 4) if top_down else _u32(head, 4)
        bits, compression = _u16(head, 10), _u32(head, 12)
        colors, pad = _u32(head, 28), 4
        if compression == 3:
            if len(head) >= 48:
                masks = struct.unpack_from("<III", head, 36) + (
                    (_u32(head, 48),) if len(head) >= 52 else (0,))
            else:                 # 40-byte header: three masks follow it
                masks = struct.unpack_from("<III", data, pos) + (0,)
                pos += 12
    else:
        raise _Unreadable(f"BMP header size {hsize}")
    return (width, height, top_down, bits, compression, colors or (1 << bits),
            pad, masks, pos)


def _bitfields(bits: int, masks: tuple):
    """The byte order of R, G, B and A (-1: none) of the BI_BITFIELDS
    masks PIL reads at ``bits`` (None at 16 bits: 5-6-5 or 5-5-5), or
    ``_Unreadable`` (PIL's "Unsupported BMP bitfields layout")."""
    if bits == 32 and masks in _BMP_MASKS32:
        return _BMP_MASKS32[masks]
    if bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
        return (2, 1, 0, -1)
    if bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                    (0x7C00, 0x3E0, 0x1F)):
        return None
    raise _Unreadable(f"BMP bitfields {masks}")


def _bitmap(data: bytes, start: int, offset: int, frame: str = "",
            alpha32: bool = False):
    """BmpImagePlugin._bitmap: the info header at ``start``, the pixels at
    ``offset`` or, where it is 0, where the reads before them end, then
    PIL's raw decoder or, for RLE8 and RLE4, its BmpRleDecoder (the host
    library). ``frame`` "ico" or "cur": the height halved, as PIL's ICO
    and CUR readers halve it (the XOR image; its decompression-bomb check
    on the whole DIB for ICO, the half for CUR); ``alpha32``: a raw 32-bit
    DIB as BGRA, as PIL reads a CUR whose bitmap is at byte 22. Returns
    (RGBA8 as PIL's ``convert("RGBA")``, where the pixels start)."""
    (width, height, top_down, bits, compression, colors, pad, masks,
     pos) = _bitmap_header(data, start)
    if offset == 14 + _u32(data, start) and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise _Unreadable(f"{bits}-bit BMP")
    rle = compression in (1, 2)
    if compression not in (0, 1, 2, 3):
        raise _Unreadable(f"BMP compression {compression}")
    if width == 0 or height == 0:
        raise _Unreadable("empty BMP")
    _check_size(width, height // 2 if frame == "cur" else height)
    if frame:
        height //= 2
        if height == 0:
            raise _Unreadable("a frame of no rows")
    palette = b""
    if bits <= 8:
        if compression == 3:
            raise _Unreadable("bitfields on a palette BMP")
        if not 0 < colors <= 65536:
            raise _Unreadable(f"BMP palette size {colors}")
        palette = data[pos:pos + pad * colors]
    elif rle:                     # PIL's RLE rawmode P on an RGB image
        raise _Unreadable(f"run-length compression at {bits} bits")
    at = offset or pos + len(palette)
    if rle:
        rows = codecs.bmp_rle(data, at, width, height, compression == 2)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        rows = _rows(data, at, height, (width * bits + 7) // 8, stride)
    if not top_down:
        rows = rows[::-1]
    out = np.full((height, width, 4), 255, np.uint8)
    if bits <= 8:
        index = (rows if rle else _unpack(rows, bits, width) if bits < 8
                 else rows[:, :width])
        grey_values = (0, 255) if colors == 2 else range(colors)
        if all(palette[i * pad:i * pad + 3] == bytes([v]) * 3
               for i, v in enumerate(grey_values)):
            # PIL drops a grey palette and reads the samples as mode "1"
            # or "L": the same values where the samples are 1 or 8 bits,
            # or come from the run-length decoder, which gives bytes (its
            # rawmode P has no unpacker for mode "1")
            if rle and colors == 2:
                raise _Unreadable("a run-length BMP of mode 1")
            if not rle and ((colors == 2) != (bits == 1)
                            or (colors != 2 and bits != 8)):
                raise _Refused(f"a {bits}-bit BMP with a {colors}-entry "
                               "grey palette")
            out[..., :3] = (index * 255 if colors == 2 else index)[..., None]
            return out, at
        n = min(len(palette) // pad, 256)
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = np.frombuffer(palette, np.uint8, n * pad).reshape(
            n, pad)[:, 2::-1]
        out[..., :3] = lut[index]
        return out, at
    if compression == 3:
        order = _bitfields(bits, masks)
    elif bits == 32 and alpha32:
        order = (2, 1, 0, 3)      # BGRA
    else:
        order = (2, 1, 0, -1)     # BGR, BGRX: the fourth byte is ignored
    if bits == 16:
        green = 6 if masks is not None and masks[0] == 0xF800 else 5
        px = rows.view("<u2").reshape(height, -1)[:, :width]
        out[..., :3] = _rgb15(px, green)
        return out, at
    px = rows.reshape(height, width, bits // 8)
    for c in range(3):
        out[..., c] = px[..., order[c]]
    if order[3] >= 0:
        out[..., 3] = px[..., order[3]]
    return out, at


# TgaImagePlugin.MODES: (image type & 7, depth) PIL has a raw mode for
_TGA_MODES = ((1, 8), (2, 16), (2, 24), (2, 32), (3, 1), (3, 8), (3, 16))


def _decode_tga(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a TGA file, as TgaImagePlugin reads it
    (see the module docstring)."""
    id_len, has_map, kind = data[0], data[1], data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    base = kind & 7
    if base not in (1, 2, 3) or kind & ~0xB:
        raise _Unreadable(f"TGA image type {kind}")
    _check_size(width, height)
    if (base, depth) == (2, 16):
        raise _Refused(f"image type {kind} at 16 bits")
    if (base, depth) not in _TGA_MODES:   # PIL makes no tile: "cannot load"
        raise _Unreadable(f"TGA image type {kind} at {depth} bits")
    if depth == 1 and kind & 8:
        # TgaRleDecode takes depth // 8 = 0 bytes a pixel: its packets
        # never fill a row, and PIL finds the file truncated
        raise _Unreadable("a run-length TGA at 1 bit")
    if depth == 1 and has_map:    # PIL cannot put a palette on mode 1
        raise _Unreadable("a 1-bit TGA with a colour map")
    pos = 18 + id_len
    lut = None
    if has_map:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        if map_depth == 16:
            raise _Refused("a 16-bit colour map")
        if map_depth != 24:       # PIL refuses 32-bit maps too
            raise _Unreadable(f"TGA map depth {map_depth}")
        k = map_depth // 8
        entries = data[pos:pos + k * size]
        pos += k * size
        if len(entries) != k * size:
            raise _Unreadable("truncated colour map")
        n = min(start + size, 256)
        lut = np.zeros((256, 3), np.uint8)
        lut[start:n] = np.frombuffer(entries, np.uint8).reshape(
            size, 3)[:n - start, ::-1]     # BGR entries
    npix, bpp = width * height, depth // 8
    if depth == 1:                # mode 1: rows padded to a byte, a set
        stride = (width + 7) // 8     # bit white
        pixels = (_unpack(_rows(data, pos, height, stride, stride), 1,
                          width) * 255).ravel()
        bpp = 1
    elif kind & 8:
        pixels = _tga_rle(data, pos, width, height, bpp)
    else:
        if pos + npix * bpp > len(data):
            raise _Unreadable("truncated pixel data")
        pixels = np.frombuffer(data, np.uint8, npix * bpp, pos)
    px = pixels.reshape(height, width, bpp)
    if not flags & 0x20:          # bottom-up, the default origin
        px = px[::-1]
    if flags & 0x10:              # right to left
        px = px[:, ::-1]
    out = np.full((height, width, 4), 255, np.uint8)
    if base == 1 and has_map:
        out[..., :3] = lut[px[..., 0]]
    elif base != 2:               # grey (+ alpha), or indices without a map
        out[..., :3] = px[..., :1]
        if bpp == 2:
            out[..., 3] = px[..., 1]
    else:                         # BGR(A)
        out[..., :3] = px[..., [2, 1, 0]]
        if bpp == 4:
            out[..., 3] = px[..., 3]
    return out


def _tga_rle(data: bytes, pos: int, width: int, height: int,
             bpp: int) -> np.ndarray:
    """The pixel bytes of a run-length TGA as PIL's TgaRleDecode reads
    them: packets of 1-128 pixels, a run of one pixel (header bit 7 set) or
    that many literal pixels; a literal packet may cross rows, a run that
    crosses a row's end is a "buffer overrun"; decoding stops at the last
    row."""
    out = bytearray()
    row, want = width * bpp, width * height * bpp
    while len(out) < want:
        if pos >= len(data):
            raise _Unreadable("truncated run-length data")
        head = data[pos]
        n = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos + 1:pos + 1 + bpp]
            if len(px) != bpp:
                raise _Unreadable("truncated run-length data")
            if len(out) % row + n * bpp > row:
                raise _Unreadable("buffer overrun")
            out += px * n
            pos += 1 + bpp
        else:
            px = data[pos + 1:pos + 1 + n * bpp]
            if len(px) != n * bpp:
                raise _Unreadable("truncated run-length data")
            out += px
            pos += 1 + n * bpp
    return np.frombuffer(bytes(out[:want]), np.uint8)


_WHITESPACE = b" \t\n\x0b\x0c\r"


def _decode_pnm(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a binary PNM file, its header read as
    PpmImagePlugin reads it and its pixels as the decoder it picks:

    - P4: mode ``1`` (rawmode ``1;I``: a set bit is black), each row
      padded to a whole byte;
    - P5 and P6 at maxval 255: the bytes; P5 at 65535: mode ``I`` from
      ``I;16B``, its high byte kept (the named deviation);
    - P5 and P6 at any other maxval: PpmDecoder's ``min(out_max,
      round(value / maxval * out_max))`` in float64, half to even, of
      1-byte samples below 256 and big-endian 2-byte ones from 256;
      ``out_max`` 65535 for P5 above 255 (mode ``I``, its high byte kept:
      the named deviation), 255 otherwise (a 16-bit P6 is scaled, not cut
      to its high byte); the data cut short is None, as PpmDecoder's short
      result is PIL's "not enough image data";
    - Pf: mode ``F``, a scale token parsed as a float (zero or not finite
      is None), little-endian where it is negative, rows bottom-up, then
      PIL's ``F`` to ``L`` (:func:`_float_grey`)."""
    pos = 0
    magic = b""
    while pos < len(data) and len(magic) < 6:
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in (b"P4", b"P5", b"P6", b"Pf"):
        if magic in (b"P1", b"P2", b"P3", b"P0CMYK", b"PyP", b"PyRGBA",
                     b"PyCMYK"):
            raise _Refused(f"{magic.decode()} (plain-text PNM and PIL's test "
                           "extensions are not decoded)")
        raise _Unreadable("not a PNM file")

    def token() -> bytes:
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            c = data[pos:pos + 1]
            pos += 1
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":         # a comment runs to CR, LF or the end
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise _Unreadable("bad PNM header")
        return tok

    width, height = int(token()), int(token())
    if magic == b"Pf":
        scale = float(token())
        if scale == 0.0 or not np.isfinite(scale):
            raise _Unreadable(f"Pf scale {scale}")
    elif magic != b"P4":
        maxval = int(token())
        if not 0 < maxval < 65536:
            raise _Unreadable(f"maxval {maxval}")
    if width <= 0 or height <= 0:
        raise _Unreadable("bad PNM header")
    _check_size(width, height)
    if magic == b"P4":
        stride = (width + 7) // 8
        rows = _rows(data, pos, height, stride, stride)
        return _grey_rgba((1 - _unpack(rows, 1, width)) * 255)
    if magic == b"Pf":
        f = _rows(data, pos, height, 4 * width, 4 * width)[::-1]
        f = np.ascontiguousarray(f).view("<f4" if scale < 0 else ">f4")
        return _grey_rgba(_float_grey(f))
    spp = 1 if magic == b"P5" else 3
    wide = maxval > 255
    px = _rows(data, pos, height, width * spp * (1 + wide),
               width * spp * (1 + wide)).view(">u2" if wide else np.uint8)
    px = px.reshape(height, width, spp)
    if maxval == 65535 and spp == 1:      # PIL's raw I;16B: the high byte
        px = px >> 8
    elif maxval != 255:                   # PpmDecoder
        out_max = 65535 if wide and spp == 1 else 255
        px = np.minimum(out_max, np.rint(px / maxval * out_max))
        if out_max == 65535:              # mode I: the high byte
            px = px.astype(np.int64) >> 8
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :3] = px.astype(np.uint8)
    return out


# ---- GIF: PIL's GifImagePlugin, the first frame ----------------------------

def _gif_palette_needed(p: bytes) -> bool:
    """GifImagePlugin._is_palette_needed: a table that is not the grey
    ramp 0, 1, 2, ... colours the image; the ramp leaves it grey."""
    return any(not (i == p[3 * i] == p[3 * i + 1] == p[3 * i + 2])
               for i in range(len(p) // 3))


def _gif_sub_blocks(data: bytes, pos: int):
    """The first data sub-block at ``pos`` (None when its length is 0)
    and where the blocks end."""
    first = None
    while True:
        if pos >= len(data):
            raise _Unreadable("truncated GIF extension")
        n = data[pos]
        if n == 0:
            return first, pos + 1
        block = data[pos + 1:pos + 1 + n]
        if len(block) != n:
            raise _Unreadable("truncated GIF extension")
        first = block if first is None else first
        pos += 1 + n


def _decode_gif(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a GIF's first frame, as PIL opens it: mode
    ``P`` with the local or the global colour table (entries past the
    table black), or ``L`` where neither colours it; the graphic control
    extension's transparency index; a frame inside or past the logical
    screen, the rest filled with index 0 (or the transparent one)."""
    if len(data) < 13:
        raise _Unreadable("truncated GIF header")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_pal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        table = data[pos:pos + n]
        pos += n
        if len(table) != n:
            raise _Unreadable("truncated colour table")
        global_pal = table if _gif_palette_needed(table) else None
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise _Unreadable("no image in the GIF file")
        kind = data[pos]
        pos += 1
        if kind == 0x21:                    # extension
            if pos >= len(data):
                raise _Unreadable("truncated GIF extension")
            label = data[pos]
            block, pos = _gif_sub_blocks(data, pos + 1)
            if label == 0xF9 and block is not None and len(block) >= 4 \
                    and block[0] & 1:
                transparency = block[3]
        elif kind == 0x2C:                  # image descriptor
            break                           # (other bytes are skipped)
    if pos + 10 > len(data):
        raise _Unreadable("truncated image descriptor")
    x0, y0, w, h, lflags = struct.unpack_from("<HHHHB", data, pos)
    pos += 9
    pal = global_pal
    if lflags & 0x80:
        n = 3 << ((lflags & 7) + 1)
        table = data[pos:pos + n]
        pos += n
        if len(table) != n:
            raise _Unreadable("truncated colour table")
        if _gif_palette_needed(table):
            pal = table
        elif global_pal is not None and transparency is not None:
            raise _Unreadable("a grey local table over a colour one, with "
                              "transparency (PIL cannot convert it)")
    if w == 0 or h == 0 or pos >= len(data):
        raise _Unreadable("empty GIF frame")
    bits = data[pos]
    npix = w * h
    try:
        found = codecs.gif_lzw(data[pos + 1:], bits, npix)
    except codecs.BrokenData as e:
        raise _Unreadable(str(e)) from None
    if found.size < npix:                   # the end code came early:
        raise _Unreadable("GIF image data ends early")  # PIL reads on
    frame = found.reshape(h, w)
    if lflags & 0x40:                       # interlaced: rows by pass
        order = np.concatenate([np.arange(s, h, d) for s, d in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    W, H = max(width, x0 + w), max(height, y0 + h)
    _check_size(W, H)
    index = np.full((H, W), 0 if transparency is None else transparency,
                    np.uint8)
    index[y0:y0 + h, x0:x0 + w] = frame
    if pal is None:                         # mode L: the index is the grey
        out = np.full((H, W, 4), 255, np.uint8)
        out[..., :3] = index[..., None]
        if transparency is not None:
            out[..., 3] = np.where(index == transparency, 0, 255)
        return out
    lut = np.zeros((256, 4), np.uint8)
    lut[:, 3] = 255
    n = min(len(pal) // 3, 256)
    lut[:n, :3] = np.frombuffer(pal, np.uint8, 3 * n).reshape(n, 3)
    if transparency is not None:
        lut[transparency, 3] = 0
    return lut[index]


# ---- TIFF: PIL's TiffImagePlugin (libtiff for compressed data) ------------

_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def _tiff_ifd(data: bytes, pos: int, order: str, pil: bool = True,
              big: bool = False) -> dict:
    """{tag: tuple of integers} of the integer tags of the IFD at ``pos``:
    a tag of an unknown type or with no values is skipped, and PIL's
    ImageFileDirectory (``pil``) stops the entries at the end of the file
    (an entry count that runs past it is clipped), where libtiff, which
    reads the IFD again for compressed data, fails, as it does on more
    than 4,096 entries. A tag whose values lie past the end stops PIL's
    reading there; libtiff skips it alone, or fails where it reads the tag
    without recovery (``_TIFF_ONE_VALUE``, BitsPerSample, SampleFormat),
    as it does where such a tag has no values. A BigTIFF's IFD (``big``)
    counts its entries in 8 bytes, each entry 20 bytes long with its
    values inline up to 8 bytes, else at an 8-byte offset (at 2**63 or
    more PIL's seek raises)."""
    head, entry, fmt = (8, 20, "HHQ8s") if big else (2, 12, "HHI4s")
    if pos + head > len(data):
        raise _Unreadable("truncated IFD")
    (count,) = struct.unpack_from(order + ("Q" if big else "H"), data, pos)
    if not pil and count > 4096:          # libtiff's sanity check
        raise _Unreadable(f"{count} IFD entries")
    if not pil and pos + head + entry * count > len(data):
        raise _Unreadable("truncated IFD (libtiff reads all its entries)")
    count = min(count, (len(data) - pos - head) // entry)
    tags = {}
    for i in range(count):
        tag, kind, n, value = struct.unpack_from(order + fmt, data,
                                                 pos + head + entry * i)
        if not pil and n == 0 and _TIFF_ONE_VALUE.get(tag, tag in (258,
                                                                  339)):
            raise _Unreadable(f"tag {tag} without values")
        if kind not in _TIFF_SIZES or n == 0:
            continue
        size = n * _TIFF_SIZES[kind]
        if not pil and tag in _TIFF_ONE_VALUE and (
                n != 1 and tag != 259 or kind not in _TIFF_TYPES):
            if _TIFF_ONE_VALUE[tag]:      # libtiff: the directory fails
                raise _Unreadable(f"tag {tag}: {n} values of type {kind}")
            continue                      # libtiff: the tag is ignored
        if size > len(value):
            (at,) = struct.unpack(order + ("Q" if big else "I"), value)
            if pil and at >= 1 << 63:
                raise _Unreadable("a tag's values past 2**63")
            value = data[at:at + size]
            if len(value) != size:
                if pil:
                    break
                if _TIFF_ONE_VALUE.get(tag, tag in (258, 339)):
                    raise _Unreadable(f"tag {tag}: values past the end")
                continue
        if kind in _TIFF_TYPES:           # (PIL takes the first value)
            tags[tag] = struct.unpack_from(f"{order}{n}{_TIFF_TYPES[kind]}",
                                           value)
        elif kind == 5 and tag in _TIFF_RATIONALS:   # as libtiff: float32
            v = struct.unpack_from(f"{order}{2 * n}I", value)
            tags[tag] = tuple(np.float32(a) / np.float32(b) if b else
                              np.float32(0) for a, b in zip(v[::2], v[1::2]))
        else:
            tags[tag] = None
    # libtiff's TIFFSetField refuses these values, failing the directory:
    # a planar configuration other than 1 or 2, 0 rows a strip, an extra
    # sample kind past 2 (but Corel's 999)
    if not pil and (tags.get(284, (1,))[0] not in (1, 2)
                    or tags.get(278, (1,))[0] == 0
                    or any(v > 2 and v != 999 for v in tags.get(338) or ())):
        raise _Unreadable("a value libtiff refuses")
    return tags


# the RATIONAL tags read, as libtiff reads them (``(float)num /
# (float)den``, 0 where den is 0): YCbCrCoefficients, ReferenceBlackWhite
_TIFF_RATIONALS = (529, 532)


# libtiff's one-value integer tags, and whether another count or a type
# that is no integer fails its reading of the directory (TIFFReadDirectory
# fetches these without recovery) or only drops the tag, with a warning;
# Compression may also hold a value a sample (checked against the samples
# in _decode_tiff), and no values fail BitsPerSample and SampleFormat too
_TIFF_ONE_VALUE = {256: True, 257: True, 259: True, 277: True, 278: True,
                   284: True, 322: True, 323: True,
                   262: False, 266: False, 317: False}


def _tiff_mode(order, photo, sample_format, fill, bps, extra):
    """The mode of PIL's OPEN_INFO for this key, or None where PIL has
    none ("unknown pixel mode"): the modes grouped by their rules."""
    ii = order == "<"
    one = len(bps) == 1 and sample_format == (1,)
    if photo in (0, 1) and one and not extra and bps[0] in (1, 2, 4, 8):
        return "1" if bps[0] == 1 else "L"
    if photo in (0, 1) and len(bps) == 1 and not extra and fill == 1:
        b, sf = bps[0], sample_format
        if (b, sf) == (8, (2,)) and photo == 1:
            return "L"
        if b == 16 and sf in ((1,), (2,)) and photo == 1 or (
                (b, sf, photo, ii) == (16, (1,), 0, True)):
            return "I" if sf == (2,) else "I;16" if ii else "I;16B"
        if (b, sf) == (12, (1,)) and photo == 1 and ii:
            return "I;16"
        if b == 32 and sf == (3,):
            return "F"
        if b == 32 and photo == 1 and (sf == (2,) or (sf == (1,) and ii)):
            return "I"
    if photo in (0, 1) and one and bps == (16,) and fill == 2 and ii \
            and photo == 1 and not extra:
        return "I;16"
    if photo == 1 and sample_format == (1,) and fill == 1 \
            and bps == (8, 8) and extra == (2,):
        return "LA"
    if photo == 2 and sample_format == (1,):
        n = len(bps)
        if bps == (8,) * n and fill == 1 and extra in (
                (), (0,), (0, 0), (0, 0, 0), (1,), (1, 0), (1, 0, 0), (2,),
                (2, 0), (2, 0, 0), (999,)) and n == 3 + len(extra) or (
                bps == (8,) * 4 and not extra and fill == 1):
            return "RGBA" if n == 4 and not extra or extra[:1] in (
                (1,), (2,), (999,)) else "RGB"
        if bps == (8, 8, 8) and fill == 2 and not extra:
            return "RGB"
        if fill == 1 and (bps == (16,) * 3 and not extra or bps == (16,) * 4
                          and extra in ((), (0,), (1,), (2,))):
            return "RGBA" if n == 4 and extra != (0,) else "RGB"
    if photo == 3 and sample_format == (1,):
        if bps in ((1,), (2,), (4,), (8,)) and not extra:
            return "P"
        if bps == (8, 8) and extra in ((0,), (2,)) and fill == 1:
            return "P" if extra == (0,) else "PA"
    if photo == 5 and sample_format == (1,) and fill == 1 and (
            (bps, extra) in (((8,) * 4, ()), ((8,) * 5, (0,)),
                             ((8,) * 6, (0, 0)), ((16,) * 4, ()))):
        return "CMYK"
    if photo == 6 and sample_format == (1,) and fill == 1 and not extra \
            and bps in ((8,), (8, 8, 8)):
        return "L" if bps == (8,) else "RGB"
    if photo == 8 and sample_format == (1,) and fill == 1 and not extra \
            and bps == (8, 8, 8):
        return "LAB"
    return None


_TIFF_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                      4: "CCITT Group 4", 5: "LZW", 7: "JPEG", 8: "Deflate",
                      32946: "Deflate", 32773: "PackBits", 34925: "LZMA",
                      50000: "ZSTD"}
# (WebP, 50001, is no codec of PIL's libtiff: None, as any unknown one)
_TIFF_REFUSED = {6: "old-style JPEG",
                 32771: "CCITT RLEW (PIL's own files do not read back)",
                 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24"}
_TIFF_FAX = (2, 3, 4)
# the codecs libtiff runs its predictor in (tif_predict.c): LZW, Deflate,
# LZMA and ZSTD; PackBits, CCITT and JPEG ignore the tag
_TIFF_PREDICTED = (5, 8, 32946, 34925, 50000)


def _lzma_open_ended(raw: bytes, nbytes: int) -> bytes:
    """The xz stream of an LZMA strip with the LZMA2 chunk that holds the
    strip's last byte made to run on past it (its compressed size the
    largest, its uncompressed size one more where it ends there), or cut
    after that byte where the chunk is stored: libtiff stops liblzma once
    the strip is full, and what liblzma finds wrong after that (the
    chunk's end, the control byte after it, the block's padding, the
    index, the footer) is never seen, but Python's ``lzma`` drops all its
    output with the error. Unchanged where the chunks do not reach the
    strip's end as they are walked."""
    if len(raw) < 13 or raw[12] == 0:
        return raw
    pos, total = 12 + (raw[12] + 1) * 4, 0
    while pos < len(raw) and raw[pos] != 0:
        control = raw[pos]
        if control in (1, 2):                 # stored
            if pos + 3 > len(raw):
                break
            size = (raw[pos + 1] << 8 | raw[pos + 2]) + 1
            if total + size >= nbytes:
                return raw[:pos + 3 + nbytes - total]
            total, pos = total + size, pos + 3 + size
            continue
        if control < 0x80 or pos + 5 > len(raw):
            break                             # liblzma fails on it
        size = ((control & 0x1F) << 16 | raw[pos + 1] << 8 | raw[pos + 2]) + 1
        if total + size >= nbytes:
            if total + size == nbytes and size < 1 << 21:
                size += 1
            out = bytearray(raw)
            out[pos:pos + 5] = bytes((control & 0xE0 | (size - 1) >> 16,
                                      (size - 1) >> 8 & 0xFF,
                                      (size - 1) & 0xFF, 0xFF, 0xFF))
            return bytes(out)
        total += size
        pos += (6 if control >> 5 & 3 >= 2 else 5) + (
            raw[pos + 3] << 8 | raw[pos + 4]) + 1
    return raw


def _tiff_lzma(raw: bytes, nbytes: int) -> np.ndarray:
    """``nbytes`` bytes of an LZMA strip or tile as libtiff's LZMADecode
    reads them through liblzma (an xz stream, never the ``.lzma`` format):
    whole where Python's ``lzma`` decodes the strip without an error, else
    fed a byte at a time, so that an error liblzma finds past the strip's
    last byte in the same call (reading ahead) does not hide it."""
    data = _lzma_open_ended(raw, nbytes)
    try:
        out = lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(
            data, nbytes)
        if len(out) == nbytes:
            return np.frombuffer(out, np.uint8)
    except lzma.LZMAError:
        pass
    dec, parts, got = lzma.LZMADecompressor(format=lzma.FORMAT_XZ), [], 0
    for k in range(len(data)):
        try:
            parts.append(dec.decompress(data[k:k + 1], nbytes - got))
        except lzma.LZMAError as e:
            raise _Unreadable(f"broken LZMA data ({e})") from None
        got += len(parts[-1])
        if got == nbytes:
            return np.frombuffer(b"".join(parts), np.uint8)
        if dec.eof:                           # the stream ends short
            break
    raise _Unreadable("LZMA data ends early")


def _tiff_chunk(raw: bytes, compression: int, nbytes: int) -> np.ndarray:
    """``nbytes`` decoded bytes of one strip or tile."""
    if compression == 5:
        if raw[:2] == b"\0\x01" or (raw[:1] == b"\0" and raw[1:2]
                                    and raw[1] & 1):
            raise _Refused("old-style LZW")
        try:
            return codecs.tiff_lzw(raw, nbytes)
        except codecs.BrokenData as e:
            raise _Unreadable(str(e)) from None
    if compression in (8, 32946):
        out = zlib.decompressobj().decompress(raw, nbytes)
        if len(out) < nbytes:
            raise _Unreadable("Deflate data ends early")
        return np.frombuffer(out, np.uint8)
    if compression == 32773:
        try:
            return codecs.packbits(raw, nbytes)
        except codecs.BrokenData as e:
            raise _Unreadable(str(e)) from None
    if compression == 34925:
        return _tiff_lzma(raw, nbytes)
    if compression == 50000:
        try:
            return codecs.tiff_zstd(raw, nbytes)
        except codecs.BrokenData as e:
            raise _Unreadable(str(e)) from None
    if len(raw) < nbytes:
        raise _Unreadable("truncated strip")
    return np.frombuffer(raw, np.uint8, nbytes)


_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)


class _FaxChunks:
    """The strips or tiles of a CCITT image as PIL reads them: libtiff's
    decoder (``codecs.Fax``) into PIL's strip or tile buffer, which PIL
    keeps from one to the next. Compression 4 stops without an error where
    its data ends, the rows after it left as the buffer held them: rows of
    the strip or tile before, or, where none wrote them, memory PIL never
    initialised (refused: PIL's image differs from one run to the next)."""

    def __init__(self, compression: int, options: int, width: int,
                 rows: int, row_bytes: int):
        self.fax = codecs.Fax(compression, options, width)
        self.buf = np.zeros((rows, row_bytes), np.uint8)
        self.known = np.zeros(rows, bool)

    def __call__(self, raw: bytes, n: int, keep: int, last: bool):
        self.known[:n] |= self.fax.decode(raw, self.buf[:n])
        if not self.known[:keep].all():
            raise _Refused("CCITT data that ends before the last row of a "
                           "strip or tile PIL has not filled before (PIL "
                           "reads those rows from uninitialised memory)")
        return self.buf[:n].copy()


class _JpegChunks:
    """The strips or tiles of a JPEG-compressed TIFF as PIL reads them:
    libtiff's JPEG codec (``jpeg.TiffDecoder``: the JPEGTables ``tables``,
    JPEGPreDecode's checks, RGB under photometric YCbCr, else the stored
    components). A stream smaller than its strip or tile is refused:
    libtiff reads what it holds and leaves the rest of PIL's buffer as it
    was."""

    def __init__(self, tables, width: int, spp: int, sampling, ycbcr: bool):
        self.dec = jpeg.TiffDecoder(tables)
        self.width, self.spp, self.sampling = width, spp, sampling
        self.ycbcr = ycbcr

    def __call__(self, raw: bytes, n: int, keep: int, last: bool):
        s = self.dec.decode(raw, self.width, n, self.spp, self.sampling,
                            last, self.ycbcr, n)
        if s.shape[0] < n or s.shape[1] < self.width:
            raise _Refused(f"a {s.shape[1]}x{s.shape[0]} JPEG stream in a "
                           f"{self.width}x{n} strip or tile (PIL keeps the "
                           "rest of its buffer)")
        return s[:n, :self.width].reshape(n, -1)


def _tiff_tag_bytes(data: bytes, at: int, order: str, tag: int,
                    big: bool = False):
    """The values of a BYTE or UNDEFINED tag of the IFD at ``at`` (of a
    BigTIFF where ``big``) as libtiff reads them (JPEGTables), None where
    it is missing, of another type or past the end of the file (libtiff
    skips it)."""
    head, entry = (8, 20) if big else (2, 12)
    (count,) = struct.unpack_from(order + ("Q" if big else "H"), data, at)
    for i in range(min(count, (len(data) - at - head) // entry)):
        t, kind, n, value = struct.unpack_from(
            order + ("HHQ8s" if big else "HHI4s"), data, at + head + entry * i)
        if t != tag:
            continue
        if kind not in (1, 6, 7) or n == 0:
            return None
        if n <= len(value):
            return value[:n]
        (pos,) = struct.unpack(order + ("Q" if big else "I"), value)
        v = data[pos:pos + n]
        return v if len(v) == n else None
    return None


def _jpeg_first_sampling(s: bytes, spp: int):
    """libtiff's JPEGFixupTagsSubsampling: a YCbCr JPEG TIFF without the
    YCbCrSubsampling tag takes the first component's sampling factors from
    the frame of its first strip or tile (``s``), where its markers lead
    to one and the factors have a TIFF equivalent; else (2, 2)."""
    p = 0

    def byte():
        nonlocal p
        p += 1
        return s[p - 1]                 # IndexError: the strip ran out

    try:
        while True:
            while byte() != 255:
                pass
            m = 255
            while m == 255:
                m = byte()
            if m == 0xD8:
                continue
            if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
                n = byte() << 8 | byte()
                if n < 2:
                    return (2, 2)
                p += n - 2
                continue
            if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                return (2, 2)
            if byte() << 8 | byte() != 8 + 3 * spp:
                return (2, 2)
            p += 7
            v = byte()
            p += 1
            for _ in range(1, spp):
                p += 1
                if byte() != 0x11:
                    return (2, 2)
                p += 1
            h, v = v >> 4, v & 15
            return (h, v) if h in (1, 2, 4) and v in (1, 2, 4) else (2, 2)
    except IndexError:
        return (2, 2)


def _libtiff_big(data: bytes, order: str) -> bool:
    """Whether libtiff (TIFFClientOpen) reads the file as a BigTIFF: the
    version 43 in the file's byte order with offset size 8 and 0 after
    it; a version other than 42 or 43, or another BigTIFF header, fails
    its open."""
    (version,) = struct.unpack_from(order + "H", data, 2)
    if version == 42:
        return False
    if version == 43 and struct.unpack_from(order + "HH", data, 4) == (8, 0):
        return True
    raise _Unreadable(f"TIFF version {version} (libtiff fails to open it)")


_MODE_BANDS = {"LA": 2, "PA": 2, "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def _libtiff_rows_fit(tags: dict, width: int, pixel_bits: int, mode: str,
                      planar: int) -> None:
    """PIL's libtiff decoder (TiffDecode.c): the row libtiff lays a strip
    or tile out in (``TIFFScanlineSize``, ``TIFFTileRowSize``, by its own
    reading of the IFD in ``tags``) must be the one PIL's unpacker reads,
    ``(width * bits / planes + 7) / 8`` at the raw mode's ``pixel_bits``,
    a plane of each band where libtiff's planes are separate (of 8 or
    16-bit samples only); a damaged IFD PIL and libtiff read apart fails
    here."""
    def g(tag, default):
        return tags.get(tag) or default

    tiled = 324 in tags
    lib_width = g(322 if tiled else 256, (0,))[0]
    lib_bits = g(258, (1,))[0]
    bands = _MODE_BANDS.get(mode, 1)
    planes = bands if planar == 2 and bands > 1 else 1
    if planes > 1 and lib_bits not in (8, 16):
        raise _Unreadable(f"separate planes of {lib_bits}-bit samples")
    rows = ((lib_width if tiled else width) * pixel_bits // planes + 7) // 8
    lib_rows = (lib_width * (g(277, (1,))[0] if planar == 1 else 1)
                * lib_bits + 7) // 8
    if rows != lib_rows:
        raise _Unreadable(f"libtiff's rows of {lib_rows} bytes, PIL's of "
                          f"{rows}")


def _decode_tiff(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a TIFF's or BigTIFF's first IFD, as PIL's
    ``convert("RGBA")`` gives it (see the module docstring)."""
    order = "<" if data[:2] == b"II" else ">"
    # PIL takes a BigTIFF by the header's third byte, so only one in
    # little-endian order (II 2B 00): its first IFD's offset at 8, 8 bytes
    big = data[2] == 43
    (at,) = struct.unpack_from(order + ("Q" if big else "I"), data,
                               8 if big else 4)
    if at == 0 or at >= 1 << 63:      # PIL: EOFError, ValueError
        raise _Unreadable(f"first IFD at {at}")
    tags = _tiff_ifd(data, at, order, big=big)
    if 0xBC01 in tags:
        raise _Unreadable("Windows Media Photo")

    def g(tag, default):
        return tags.get(tag) or default

    compression = g(259, (1,))[0]
    photo = g(262, (0,))[0]
    if compression == 6:
        photo = 6
    fill = g(266, (1,))[0]
    if 256 not in tags or 257 not in tags:
        raise _Unreadable("missing dimensions")
    width, height = tags[256][0], tags[257][0]
    sample_format = g(339, (1,))
    if len(sample_format) > 1 and set(sample_format) == {1}:
        sample_format = (1,)
    bps, extra = g(258, (1,)), tuple(g(338, ()))
    spp = g(277, (3 if compression == 6 and photo in (2, 6) else 1,))[0]
    if spp > 6:
        raise _Unreadable("too many samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _Unreadable("unknown data organization")
    mode = _tiff_mode(order, photo, sample_format, fill, tuple(bps), extra)
    if mode is None:
        raise _Unreadable("unknown pixel mode")
    if compression in _TIFF_REFUSED:
        raise _Refused(f"compression {compression} "
                       f"({_TIFF_REFUSED[compression]})")
    if compression not in _TIFF_COMPRESSIONS:
        raise _Unreadable(f"compression {compression}")
    if mode == "LAB":
        raise _Refused("CIELab")
    orientation = g(274, (1,))[0]     # PIL's exif_transpose, at the end
    ycbcr, lib_big = None, big
    if compression != 1:
        # PIL hands compressed data to libtiff, which opens the file
        # itself and lays the data out by its own reading of the IFD
        lib_big = _libtiff_big(data, order)
        lib_at = struct.unpack_from(order + ("Q" if lib_big else "I"), data,
                                    8 if lib_big else 4)[0]
        if lib_at != at:              # the IFD it reads when it opens
            _tiff_ifd(data, lib_at, order, pil=False, big=lib_big)
        tags = _tiff_ifd(data, at, order, pil=False, big=lib_big)
        if 1 < len(g(259, (1,))) < spp:   # fewer than a value a sample
            raise _Unreadable("a Compression tag of too few values")
        fill = g(266, (1,))[0]
        if len(g(338, ())) > spp:         # setExtraSamples refuses it
            raise _Unreadable("more extra samples than samples")
        if photo == 6 and compression != 7:   # libtiff's RGBA reader
            ycbcr = _libtiff_ycbcr(tags, spp, g(274, (1,))[0])
    planar = g(284, (1,))[0]
    bits = bps[0]
    predictor = g(317, (1,))[0] if compression in _TIFF_PREDICTED else 1
    if compression in _TIFF_FAX and (bits != 1 or (spp > 1 and planar == 1)):
        raise _Unreadable("CCITT data of other than 1-bit samples")
    if compression == 7:
        if planar == 2:
            raise _Refused("JPEG with separate planes")
        if bits == 12:
            raise _Refused("12-bit JPEG")
        if bits != 8:                     # JPEGPreDecode: data precision
            raise _Unreadable(f"JPEG data at {bits} bits")
        if photo == 6 and spp != 3:
            raise _Unreadable(f"YCbCr JPEG with {spp} samples a pixel")
    # libtiff's PredictorSetup: horizontal differencing of 8, 16, 32 or
    # 64-bit samples, the floating-point predictor of IEEE floats of 16,
    # 24, 32 or 64 bits; anything else fails the first strip
    if predictor == 2 and bits not in (8, 16, 32, 64) or predictor == 3 and (
            g(339, (1,))[0] != 3 or bits not in (16, 24, 32, 64)) \
            or predictor not in (1, 2, 3):
        raise _Unreadable(f"predictor {predictor} at {bits} bits")
    if compression != 1 and ycbcr is None:
        _libtiff_rows_fit(tags, width, spp * bits, mode, planar)
    if width == 0 or height == 0:
        raise _Unreadable("empty image")
    _check_size(width, height)
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp            # samples per plane pixel
    if photo == 6 and compression == 1 and per == 3:
        per = 4                   # PIL's raw RGBX: 4 bytes a pixel
        if 324 in tags:
            raise _Refused("uncompressed YCbCr tiles")
    if 324 in tags:
        if 322 not in tags or 323 not in tags:
            raise _Unreadable("invalid tile dimensions")
        cw, ch = tags[322][0], tags[323][0]
        offsets, counts = tags[324], g(325, ())
    elif 273 in tags:
        cw, ch = width, g(278, (height,))[0]
        if ch == 0 and compression == 1:  # PIL's tiles of no rows
            raise _Unreadable("0 rows a strip")
        offsets, counts = tags[273], g(279, ())
    else:
        raise _Unreadable("unknown data organization")
    # PIL's raw decoder takes the last offset of a strip or tile that
    # covers the image
    whole = (cw, ch) == (width, height) and planar != 2
    if 324 not in tags:
        ch = min(ch or height, height)
    if cw == 0 or ch == 0:
        raise _Unreadable("empty strips or tiles")
    _check_size(cw, ch)
    tiled = 324 in tags
    row_bytes = (cw * per * bits + 7) // 8
    nx, ny = -(-width // cw), -(-height // ch)
    if planar == 2 and compression == 1 and bits > 8 and spp > 1:
        rgba = _tiff_rgba(_pil_raw_planes(
            data, offsets, (width, height), (cw, ch), mode, photo, extra,
            bps), mode, photo, 8, extra, None)
        return np.ascontiguousarray(
            _EXIF_TRANSPOSE.get(orientation, lambda a: a)(rgba))
    if len(offsets) < planes * nx * ny:
        raise _Unreadable("too few strips or tiles")
    if orientation in (5, 6, 7, 8) and compression == 1 and \
            planes * nx * ny == 1 and _pil_maps(mode, photo, bits, extra,
                                                fill):
        raise _Refused(f"an uncompressed single-strip {mode} TIFF at "
                       f"orientation {orientation} (PIL maps its samples "
                       "with the width and height swapped)")
    if nx > 1 and cw * per * bits % 8:
        raise _Refused("tiles that end inside a byte")
    out = np.zeros((planes, height, row_bytes * nx), np.uint8)
    if compression in _TIFF_FAX:
        reader = _FaxChunks(compression, g(292, (0,))[0] if compression == 3
                            else 0, cw, ch, row_bytes)
    elif compression == 7:
        if photo != 6:
            sampling = (1, 1)
        elif len(g(530, ())) == 2:
            sampling = tuple(g(530, ()))
        else:           # JPEGFixupTagsSubsampling: the first strip's frame
            sampling = _jpeg_first_sampling(data[offsets[0]:offsets[0] + (
                counts[0] if counts else 0)], spp) if offsets[0] else (2, 2)
        reader = _JpegChunks(_tiff_tag_bytes(data, at, order, 347, lib_big),
                             cw, spp, sampling, photo == 6)
    else:
        reader = None
    cells = planes * nx * ny
    jobs = list(enumerate(offsets[:cells]))
    if compression == 1 and planes == 1:
        # PIL's raw decoder reads a tile for every offset, its cell counted
        # on past the last, in the offsets' order: a later one over an
        # earlier one of its cell (of two in a row, only the later)
        jobs = [(0, offsets[-1])] if whole else sorted(
            ((k % cells, off) for k, off in enumerate(offsets)),
            key=lambda job: job[1])
        jobs = [job for i, job in enumerate(jobs)
                if i + 1 == len(jobs) or jobs[i + 1][0] != job[0]]
    for k, offset in jobs:
        plane, rest = divmod(k, nx * ny)
        ty, tx = divmod(rest, nx)
        y0 = ty * ch
        rows = min(ch, height - y0)
        if compression == 1:          # PIL's raw decoder: the rows it needs,
            n = rows * row_bytes      # the last one of an edge tile only
            if planes == 1 and (tx + 1) * cw > width:   # to the image's edge
                n -= row_bytes - ((width - tx * cw) * per * bits + 7) // 8
        else:                         # libtiff: a whole tile, or the strip
            n = counts[k] if k < len(counts) else 0
        raw = data[offset:offset + n]
        if compression != 1 and len(raw) < n:   # libtiff: "Read error on
            raise _Unreadable("truncated strip or tile")   # strip/tile"
        if compression == 1 and len(raw) == n:
            raw = raw.ljust(rows * row_bytes, b"\0")
        if fill == 2:                 # libtiff reverses the stored bits
            raw = _REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        if reader is not None:        # a whole tile, or the strip's rows
            chunk = reader(raw, ch if tiled else rows, rows,
                           not tiled and y0 + rows == height)
        else:
            chunk = _tiff_chunk(raw, compression,
                                (rows if compression == 1 or not tiled
                                 else ch) * row_bytes).reshape(-1, row_bytes)
        if predictor == 2:            # in the sample's own unsigned dtype
            r = chunk.shape[0]
            if bits == 8:
                chunk = np.cumsum(chunk.reshape(r, -1, per), axis=1,
                                  dtype=np.uint8).reshape(r, row_bytes)
            else:
                dt = np.dtype(f"{order}u{bits // 8}")
                s = chunk.view(dt).astype(dt.newbyteorder("=")).reshape(
                    r, -1, per)
                chunk = np.cumsum(s, axis=1, dtype=s.dtype).astype(
                    dt).view(np.uint8).reshape(r, row_bytes)
        elif predictor == 3:
            chunk = _fp_acc(chunk, per, bits // 8, order)
        out[plane, y0:y0 + rows, tx * row_bytes:(tx + 1) * row_bytes] = \
            chunk[:rows]
    if compression != 1 and order == ">" and mode in ("I", "F"):
        # PIL reads libtiff's native-order samples as big-endian (only
        # its I;16B rawmodes are made native): their bytes swapped
        order = "<"
    kind = "f" if mode == "F" else "i" if mode == "I" else "u"
    samples = _tiff_samples(out, bits, width, per, order, kind)
    samples = (np.concatenate(list(samples), axis=-1) if planar == 2
               else samples[0])
    if ycbcr is not None:             # (at orientation 1 only)
        return _libtiff_ycbcr_rgba(samples, *ycbcr)
    rgba = _tiff_rgba(samples, mode, photo, bits, extra, tags.get(320))
    return np.ascontiguousarray(
        _EXIF_TRANSPOSE.get(orientation, lambda a: a)(rgba))


# PIL's TIFF load_end runs ImageOps.exif_transpose: the Orientation tag's
# Image.Transpose method, as numpy views of [H, W, 4]
_EXIF_TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
                   4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
                   6: lambda a: np.rot90(a, -1),
                   7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
                   8: lambda a: np.rot90(a, 1)}


def _pil_maps(mode: str, photo: int, bits: int, extra, fill: int) -> bool:
    """Whether PIL memory-maps an uncompressed one-strip file of this key
    (its OPEN_INFO raw mode is its mode and one of Image._MAPMODES: L, P,
    RGBA and CMYK at 8 bits, L not inverted, P, RGBA and CMYK with no
    extra samples but RGBA's alpha; I;16 and I;16B at 16), and so, at
    orientations 5-8, maps the samples at the size it has already swapped
    (the port refuses those)."""
    if fill != 1:
        return False
    if mode in ("I;16", "I;16B"):
        return bits == 16
    return bits == 8 and (mode == "L" and photo != 0 or mode in (
        "P", "CMYK") and not extra or mode == "RGBA" and extra in (
            (), (2,), (999,)))


def _fp_acc(chunk: np.ndarray, stride: int, size: int,
            order: str) -> np.ndarray:
    """libtiff's ``fpAcc`` (the floating-point predictor) on [rows, row
    bytes]: each row's bytes summed ``stride`` (the samples a pixel)
    apart, then its ``size`` byte planes, the most significant first,
    gathered into samples, which are given in the file's byte order (as
    the port keeps every decoded strip; libtiff gives them in the host's,
    without its swap of a big-endian file's samples)."""
    r, n = chunk.shape
    acc = np.cumsum(chunk.reshape(r, -1, stride), axis=1, dtype=np.uint8)
    big = acc.reshape(r, size, n // size).transpose(0, 2, 1)
    return np.ascontiguousarray(big if order == ">" else big[..., ::-1]
                                ).reshape(r, n)


def _pil_raw_planes(data: bytes, offsets, size, cell, mode: str, photo: int,
                    extra, bps) -> np.ndarray:
    """[H, W, bands] uint8 of an uncompressed TIFF of separate 16-bit
    planes as PIL reads it: each strip or tile through PIL's raw decoder
    under one letter of the raw mode (``RGB;16L``'s ``R``, ``G``, ``B``)
    as its plane's raw mode, so 8-bit samples: a row's bytes read as
    pixels, the row's second half in the row below (a quirk of the
    reference copied, not fixed). Rows lie a tile's width apart, or, in a
    tile past the image's right edge, PIL's ``int(w * sum(bits) / 8 /
    bands)`` bytes; a strip or tile past the last plane, or under a letter
    that is no band of the mode (``X``, ``a``), fails; the bands of
    strips or tiles the file does not have are zeros."""
    (width, height), (cw, ch) = size, cell
    letters = ("CMYK" if photo == 5 else "RGB" if len(bps) == 3 else
               {(0,): "RGBX", (1,): "RGBa"}.get(extra, "RGBA"))
    bands = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}[mode]
    out = np.zeros((height, width, len(bands)), np.uint8)
    x = y = layer = 0
    for off in offsets:
        if layer >= len(letters) or letters[layer] not in bands:
            raise _Unreadable(f"separate plane {layer} of raw mode {letters}")
        x1, y1 = min(x + cw, width), min(y + ch, height)
        line = x1 - x
        stride = 0
        if x + cw > width:
            stride = int(cw * sum(bps) / 8 / (len(extra) + (
                4 if photo == 5 else 3)))
            if stride < line:
                raise _Unreadable("a raw stride shorter than its line")
        step = stride or line
        need = (y1 - y - 1) * step + line
        raw = data[off:off + need]
        if len(raw) < need:
            raise _Unreadable("truncated strip or tile")
        rows = np.frombuffer(raw.ljust((y1 - y) * step, b"\0"), np.uint8)
        out[y:y1, x:x1, bands.index(letters[layer])] = rows.reshape(
            y1 - y, step)[:, :line]
        x += cw
        if x >= width:
            x, y = 0, y + ch
            if y >= height:
                y, layer = 0, layer + 1
    return out


def _tiff_samples(rows: np.ndarray, bits: int, width: int, per: int,
                  order: str, kind: str = "u") -> np.ndarray:
    """[planes, H, W, per] samples of [planes, H, row bytes] data: uint8
    for 1 to 8 bits, uint16 at 12 bits (most significant first, PIL's
    ``I;12``), at 16 and 32 bits unsigned (``kind`` "u"), signed ("i":
    mode ``I``) or float32 ("f")."""
    planes, height = rows.shape[:2]
    n = width * per
    if bits in (16, 32):
        dt = np.dtype(f"{order}{kind}{bits // 8}")
        s = rows[..., :n * bits // 8].copy().view(dt).astype(dt.newbyteorder(
            "="))
    elif bits == 8:
        s = rows[..., :n]
    elif bits == 12:
        b = rows[..., :(n * 3 + 1) // 2].astype(np.uint16)
        b = np.concatenate([b, np.zeros((planes, height, -b.shape[-1] % 3),
                                        np.uint16)], -1)
        b = b.reshape(planes, height, -1, 3)
        s = np.stack([b[..., 0] << 4 | b[..., 1] >> 4,
                      (b[..., 1] & 15) << 8 | b[..., 2]], -1).reshape(
            planes, height, -1)[..., :n]
    else:
        flat = rows.reshape(planes * height, -1)
        s = _unpack(flat, bits, n).reshape(planes, height, n)
    return s.reshape(planes, height, width, per)


def _float_grey(f: np.ndarray) -> np.ndarray:
    """PIL's mode ``F`` to ``L``: truncated and clipped to 0..255, NaN 0."""
    return np.where(np.isnan(f), 0.0, np.clip(f, 0.0, 255.0)).astype(
        np.uint8)


def _libtiff_floats(tags: dict, tag: int, n: int, default) -> list:
    """libtiff's float32 array of a RATIONAL or integer tag of ``n``
    values, ``default`` where it is missing or has another count (libtiff
    ignores the tag then, with a warning)."""
    v = tags.get(tag, default)
    if v is None:
        raise _Refused(f"tag {tag} of a type other than RATIONAL or integer")
    return [np.float32(x) for x in (v if len(v) == n else default)]


def _libtiff_ycbcr(tags: dict, spp: int, orientation: int):
    """(luma, reference black and white) of a compressed YCbCr TIFF, which
    PIL reads through libtiff's RGBA reader (``TIFFRGBAImageGet``), after
    its checks; the subsampling other than (1, 1) and an orientation the
    reader would turn by are refused."""
    if spp != 3:                  # TIFFReadDirectory: zero strip size
        raise _Unreadable(f"YCbCr with {spp} samples a pixel")
    sub = tags.get(530) or ()
    sub = tuple(sub) if len(sub) == 2 else (2, 2)   # libtiff's default
    if sub != (1, 1):
        raise _Refused(f"YCbCr subsampling {sub}")
    if orientation != 1:
        raise _Refused(f"YCbCr at orientation {orientation} (libtiff's "
                       "RGBA reader turns the image by it)")
    # TIFFVGetFieldDefaulted; TIFFDefaultRefBlackWhite for YCbCr
    luma = _libtiff_floats(tags, 529, 3, (0.299, 0.587, 0.114))
    ref = _libtiff_floats(tags, 532, 6, (0, 255, 128, 255, 128, 255))
    if luma[1] == 0:              # initYCbCrConversion's checks
        raise _Unreadable("YCbCrCoefficients with a zero green")
    if not all(np.float32(-0x7FFFFFFF + 128) < f < np.float32(0x7FFFFFFF)
               for f in ref):
        raise _Unreadable("ReferenceBlackWhite out of range")
    return luma, ref


def _libtiff_ycbcr_tables(luma, ref):
    """libtiff 4.7's ``TIFFYCbCrToRGBInit`` (tif_color.c): the Y, Cr->R,
    Cb->B, Cr->G and Cb->G tables of 256 entries, its float32 arithmetic
    (``Code2V``, ``CLAMPw``, truncation to int32) and ``FIX`` with
    ``SHIFT`` 16."""
    f32 = np.float32

    def fix(f):                   # FIX(CLAMP(f, 0.0F, 2.0F))
        f = f32(0) if not f >= 0 else min(f, f32(2))
        return int(np.float64(f * f32(65536)) + 0.5)

    red, green, blue = luma
    f1 = f32(2) - f32(2) * red
    f3 = f32(2) - f32(2) * blue
    d1, d2 = fix(f1), -fix(red * f1 / green)
    d3, d4 = fix(f3), -fix(blue * f3 / green)

    def code2v(c, rb, rw, cr):
        span = rw - rb
        v = f32(c - np.trunc(rb).astype(np.int64)) * f32(cr) / (
            span if span != 0 else f32(1))
        # CLAMPw to -4096..4096 (float32), then the int32 cast truncates
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)

    x = np.arange(-128, 128, dtype=np.int64)
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    half = 1 << 15
    y = code2v(x + 128, ref[0], ref[1], 255)
    return (y, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half)


def _libtiff_ycbcr_rgba(ycc: np.ndarray, luma, ref) -> np.ndarray:
    """[H, W, 4] RGBA of [H, W, 3] uint8 YCbCr samples as libtiff's
    ``putcontig8bitYCbCr11tile`` (and its separate-plane twin) converts
    them through ``TIFFYCbCrtoRGB``: table sums clamped to 0..255."""
    y_tab, cr_r, cb_b, cr_g, cb_g = _libtiff_ycbcr_tables(luma, ref)
    y = y_tab[ycc[..., 0]]
    cb, cr = ycc[..., 1], ycc[..., 2]
    out = np.full(ycc.shape[:-1] + (4,), 255, np.uint8)
    out[..., 0] = np.clip(y + cr_r[cr], 0, 255)
    out[..., 1] = np.clip(y + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(y + cb_b[cb], 0, 255)
    return out


def _tiff_rgba(s: np.ndarray, mode: str, photo: int, bits: int, extra,
               colormap) -> np.ndarray:
    """RGBA8 of [H, W, spp] samples as PIL's rawmode unpacks them and
    ``convert("RGBA")`` converts the mode."""
    h, w = s.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "F":
        out[..., :3] = _float_grey(s[..., 0])[..., None]
        return out
    if mode == "I":                   # signed, or 32-bit: clipped
        return _grey_rgba(np.clip(s[..., 0], 0, 255).astype(np.uint8))
    if bits in (12, 16):              # the high byte (see the docstring)
        s = (s >> bits - 8).astype(np.uint8)
    if mode == "CMYK":                # not inverted: PIL's cmyk2rgb
        return jpeg.inverted_cmyk_rgba(255 - s[..., :4])
    if mode in ("P", "PA"):
        if colormap is None or len(colormap) < 3 * (1 << bits):
            raise _Unreadable("palette image without a full colour map")
        n = 1 << bits
        cmap = (np.array(colormap[:3 * n]) // 256).astype(np.uint8)
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[:n, :3] = cmap.reshape(3, n).T
        out = lut[s[..., 0]]
        if mode == "PA":
            out[..., 3] = s[..., 1]
        return out
    if mode in ("1", "L", "I;16", "I;16B", "LA"):
        grey = s[..., 0]
        if bits < 8:
            grey = (grey * (255 // ((1 << bits) - 1))).astype(np.uint8)
        if photo == 0 and bits <= 8:
            grey = 255 - grey
        out[..., :3] = grey[..., None]
        if mode == "LA":
            out[..., 3] = s[..., 1]
        return out
    out[..., :3] = s[..., :3]
    if mode == "RGBA":
        a = s[..., 3]
        out[..., 3] = a
        if extra[:1] == (1,):         # associated alpha: PIL's RGBa
            rgb = s[..., :3].astype(np.int32)
            div = np.minimum(rgb * 255 // np.maximum(a, 1)[..., None], 255)
            keep = (a == 255)[..., None]
            out[..., :3] = np.where(keep, rgb, np.where(
                (a == 0)[..., None], 0, div)).astype(np.uint8)
    return out


# ---- PSD: PIL's PsdImagePlugin, the merged image ---------------------------

# (colour mode, bits) -> (PIL's mode, channels it reads)
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _decode_psd(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a PSD's merged image, as PIL opens it
    before any ``seek``: raw or RLE (PackBits rows) channels, the colour
    modes PIL reads at 8 bits (bitmap and grey, multichannel and duotone
    as their first channel, indexed, RGB with a 4th channel as alpha, CMYK
    stored inverted) and bitmap at 1 bit, read as PIL reads it (a set bit
    is white); colour mode data, resources and layers skipped by their
    lengths."""
    if len(data) < 26:
        raise _Unreadable("truncated PSD header")
    version, channels, height, width, bits, cmode = struct.unpack_from(
        ">H6xHIIHH", data, 4)
    if version != 1:
        raise _Unreadable(f"PSD version {version}")
    if (cmode, bits) not in _PSD_MODES:
        raise _Unreadable(f"PSD colour mode {cmode} at {bits} bits")
    mode, n = _PSD_MODES[(cmode, bits)]
    if n > channels:
        raise _Unreadable("not enough channels")
    if mode == "LAB":
        raise _Refused("CIELab")
    if mode == "RGB" and channels == 4:
        mode, n = "RGBA", 4
    pos = 26
    palette = None
    for section in range(3):      # colour mode data, resources, layers
        if pos + 4 > len(data):
            raise _Unreadable("truncated PSD")
        (size,) = struct.unpack_from(">I", data, pos)
        if section == 0 and mode == "P" and size == 768:
            palette = data[pos + 4:pos + 4 + 768]
        pos += 4 + size
    if pos + 2 > len(data):
        raise _Unreadable("truncated PSD")
    (compression,) = struct.unpack_from(">H", data, pos)
    pos += 2
    if width == 0 or height == 0:
        raise _Unreadable("empty PSD")
    _check_size(width, height)
    row_bytes = (width + 7) // 8 if bits == 1 else width
    view = memoryview(data)
    planes = []
    if compression == 0:
        for c in range(n):        # PIL steps width * height per channel
            start = pos + c * width * height
            if start + row_bytes * height > len(data):
                raise _Unreadable("truncated PSD image data")
            planes.append(np.frombuffer(data, np.uint8, row_bytes * height,
                                        start))
    elif compression == 1:
        if pos + 2 * n * height > len(data):
            raise _Unreadable("truncated PSD")
        counts = np.frombuffer(data, ">u2", n * height, pos).astype(np.int64)
        start = pos + 2 * n * height
        for c in range(n):
            try:
                planes.append(codecs.packbits(view[start:], row_bytes,
                                              height))
            except codecs.BrokenData as e:
                raise _Unreadable(str(e)) from None
            start += int(counts[c * height:(c + 1) * height].sum())
    else:
        raise _Unreadable(f"PSD compression {compression}")
    px = np.stack([p.reshape(height, row_bytes) for p in planes], -1)
    out = np.full((height, width, 4), 255, np.uint8)
    if mode == "1":
        out[..., :3] = (_unpack(px[..., 0], 1, width) * 255)[..., None]
    elif mode == "L":
        out[..., :3] = px[..., :1]
    elif mode == "P":
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        if palette is not None:   # else PIL's empty palette: black
            lut[:, :3] = np.frombuffer(palette, np.uint8).reshape(3, 256).T
        out = lut[px[..., 0]]
    elif mode == "CMYK":          # stored inverted, as JPEG's
        out = jpeg.inverted_cmyk_rgba(px)
    else:
        out[..., :n] = px[..., :n]
    return out


# ---- SGI, PCX, IM: PIL's SgiImagePlugin, PcxImagePlugin, ImImagePlugin ----

def _grey_rgba(grey: np.ndarray) -> np.ndarray:
    out = np.full(grey.shape + (4,), 255, np.uint8)
    out[..., :3] = grey[..., None]
    return out


def _palette_lut(palette: bytes) -> np.ndarray:
    """[256, 4] RGBA of RGB triplets, opaque; entries past them black."""
    n = min(len(palette) // 3, 256)
    lut = np.zeros((256, 4), np.uint8)
    lut[:, 3] = 255
    lut[:n, :3] = np.frombuffer(palette, np.uint8, 3 * n).reshape(n, 3)
    return lut


# SgiImagePlugin.MODES: (bytes a sample, dimension, channels)
_SGI_MODES = ((1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3),
              (2, 3, 3), (1, 3, 4), (2, 3, 4))


def _decode_sgi(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of an SGI file, as SgiImagePlugin reads it:
    verbatim (each channel's rows in turn) or RLE (the host library's
    expansion of PIL's SgiRleDecode.c), rows bottom-up, L, RGB or RGBA at
    1 or 2 bytes a sample (the high byte kept, as PIL's ``;16B`` rawmodes
    keep it)."""
    if len(data) < 12:
        raise _Unreadable("truncated SGI header")
    compression, bpc = data[2], data[3]
    dimension, width, height, bands = struct.unpack_from(">4H", data, 4)
    if (bpc, dimension, bands) not in _SGI_MODES:
        raise _Unreadable("Unsupported SGI image mode")
    if width == 0 or height == 0:
        raise _Unreadable("empty SGI image")
    _check_size(width, height)
    if compression == 0:
        size = bands * height * width * bpc
        if 512 + size > len(data):
            raise _Unreadable("truncated SGI image data")
        planes = np.frombuffer(data, np.uint8, size, 512).reshape(
            bands, height, width, bpc)
        px = np.moveaxis(planes[..., 0], 0, -1)
    elif compression == 1:
        try:
            rows = codecs.sgi_rle(data, width, height, bands, bpc)
        except codecs.BrokenData as e:
            raise _Unreadable(str(e)) from None
        px = rows.reshape(height, width, bands, bpc)[..., 0]
    else:                         # PIL makes no tile: "cannot load"
        raise _Unreadable(f"SGI compression {compression}")
    px = px[::-1]
    if bands == 1:
        return _grey_rgba(px[..., 0])
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :bands] = px
    return out


_GREY_RAMP = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()


def _decode_pcx(data: bytes, start: int = 0) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a PCX file (or of the DCX page at byte
    ``start``, whose palette is still the file's last 769 bytes), as
    PcxImagePlugin reads it:
    1 bit in 1 plane (mode ``1``), 2 or 4 (``P;2L``, ``P;4L`` with the
    header's 16 colours), version 5 at 8 bits in 1 plane (``L``, or ``P``
    where the last 769 bytes are ``0x0C`` and a palette other than the
    grey ramp) or 3 (``RGB;L``); the lines run-length decoded by the host
    library as PIL's PcxDecode.c decodes them, PIL's stride rule
    included."""
    if len(data) < start + 68:
        raise _Unreadable("truncated PCX header")
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, start + 4)
    width, height = x1 + 1 - x0, y1 + 1 - y0
    if width <= 0 or height <= 0:     # (PIL: "bad PCX image size")
        raise _Unreadable(f"PCX image size {width}x{height}")
    version, bits, planes = data[start + 1], data[start + 3], data[start + 65]
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, palette = "P;L", data[start + 16:start + 64]
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < 769:       # PIL's seek(-769, END) raises
            raise _Unreadable("PCX file shorter than its palette")
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != _GREY_RAMP:
            mode, palette = "P", tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise _Unreadable("unknown PCX mode")
    _check_size(width, height)
    # CVE-2020-35653: PIL's own stride, made even where the header's differs
    stride = (width * bits + 7) // 8
    if _u16(data, start + 66) != stride:
        stride += stride % 2
    try:
        lines = codecs.pcx_rle(memoryview(data)[start + 128:], width,
                               planes * bits, planes * stride, height)
    except codecs.BrokenData as e:
        raise _Unreadable(str(e)) from None
    if mode == "1":
        return _grey_rgba(_unpack(lines, 1, width) * 255)
    if mode == "P;L":             # unpackP2L/P4L: planes (w + 7) // 8 apart
        s = (width + 7) // 8
        index = sum(_unpack(lines[:, p * s:(p + 1) * s], 1, width) << p
                    for p in range(planes)).astype(np.uint8)
        return _palette_lut(palette)[index]
    if mode == "L":
        return _grey_rgba(lines[:, :width])
    if mode == "P":
        return _palette_lut(palette)[lines[:, :width]]
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :3] = lines[:, :3 * width].reshape(height, 3, width).transpose(
        0, 2, 1)
    return out


# ImImagePlugin.OPEN: "Image type" -> (mode, rawmode), built as PIL builds it
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}",
                                                             f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")

# (mode, rawmode) decoded here -> (samples a pixel, dtype of a sample): the
# 15 modes of PIL's IM writer (P and PA are Greyscale and LA with a Lut)
_IM_DECODED = {
    ("1", "1"): (1, None), ("L", "L"): (1, "u1"), ("P", "P"): (1, "u1"),
    ("LA", "LA;L"): (2, "u1"), ("PA", "PA;L"): (2, "u1"),
    ("I", "I;32S"): (1, "<i4"), ("I;16", "I;16"): (1, "<u2"),
    ("I;16L", "I;16L"): (1, "<u2"), ("I;16B", "I;16B"): (1, ">u2"),
    ("F", "F;32F"): (1, "<f4"), ("RGB", "RGB;L"): (3, "u1"),
    ("RGBA", "RGBA;L"): (4, "u1"), ("RGB", "RGBX;L"): (4, "u1"),
    ("CMYK", "CMYK;L"): (4, "u1"), ("YCbCr", "YCbCr;L"): (3, "u1")}


def _im_number(v: str):
    try:
        return int(v)
    except ValueError:
        return float(v)


def _decode_im(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of an IM file's first frame, as ImImagePlugin
    reads its header (a ``Lut`` that is not grey makes Greyscale ``P`` and
    LA ``PA``) and PIL's ``convert("RGBA")`` converts its mode; rows
    bottom-up, each row's bands one after another. 16-bit grey keeps the
    high byte (the named deviation); the other image types PIL opens are
    refused."""
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, known, pos, c = "L", 0, 0, b""
    while True:
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if c in (b"", b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        line, pos = c + data[pos:end], end
        if len(line) > 100:
            raise _Unreadable("IM header line over 100 bytes")
        m = _IM_LINE.match(line[:-2] if line.endswith(b"\r\n") else
                           line.removesuffix(b"\n"))
        if not m:
            raise _Unreadable("IM header syntax")
        known += m.group(1) in _IM_TAGS
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
    if not known:
        raise _Unreadable("no IM header")
    while c and c != b"\x1a":
        c = data[pos:pos + 1]
        pos += 1
    if not c:
        raise _Unreadable("IM header without its end")
    mode, size = info["Image type"], info["Image size (x*y)"]
    if not (isinstance(size, tuple) and len(size) == 2 and all(
            isinstance(n, int) and n > 0 for n in size)):
        raise _Unreadable(f"IM image size {size}")
    width, height = size
    _check_size(width, height)
    palette = None
    if "Lut" in info:             # 768 bytes: planar R, G and B tables
        lut = data[pos:pos + 768]
        pos += 768
        if len(lut) < 768:
            raise _Unreadable("truncated IM palette")
        t = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((t[0] == t[1]).all() and (t[1] == t[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode = "P" if mode in ("L", "P") else "PA"
            rawmode = "P" if mode == "P" else "PA;L"
            palette = t.T.tobytes()
    if (mode, rawmode) not in _IM_DECODED:
        if (mode, rawmode) in set(_IM_OPEN.values()):
            raise _Refused(f"image type {mode} ({rawmode})")
        raise _Unreadable(f"IM mode {mode}")
    n, dtype = _IM_DECODED[(mode, rawmode)]
    if dtype is None:             # mode 1: bits, most significant first
        rows = _rows(data, pos, height, (width + 7) // 8, (width + 7) // 8)
        return _grey_rgba(_unpack(rows[::-1], 1, width) * 255)
    step = np.dtype(dtype).itemsize * width
    rows = _rows(data, pos, height, n * step, n * step)[::-1]
    bands = np.ascontiguousarray(rows).view(dtype).reshape(
        height, n, width).transpose(0, 2, 1)
    if mode in ("P", "PA"):
        out = _palette_lut(palette)[bands[..., 0]]
        if mode == "PA":
            out[..., 3] = bands[..., 1]
        return out
    if mode in ("L", "LA"):
        out = _grey_rgba(bands[..., 0])
        if mode == "LA":
            out[..., 3] = bands[..., 1]
        return out
    if mode == "I":
        return _grey_rgba(np.clip(bands[..., 0], 0, 255).astype(np.uint8))
    if mode.startswith("I;16"):   # the high byte (the named deviation)
        return _grey_rgba((bands[..., 0] >> 8).astype(np.uint8))
    if mode == "F":
        return _grey_rgba(_float_grey(bands[..., 0]))
    if mode == "CMYK":
        return jpeg.inverted_cmyk_rgba(255 - bands)
    if mode == "YCbCr":
        return _ycbcr_rgba(bands)
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :3] = bands[..., :3]
    if mode == "RGBA":
        out[..., 3] = bands[..., 3]
    return out


def _ycc_table(k: float) -> np.ndarray:
    """A table of ConvertYCbCr.c: ``k * (i - 128)`` in 6 fractional bits,
    + 0.5 and truncated towards zero, as its tables were generated."""
    return np.trunc(k * (np.arange(256) - 128) * 64 + 0.5).astype(np.int32)


_YCC_R_CR, _YCC_G_CB = _ycc_table(1.40200), _ycc_table(-0.34414)
_YCC_G_CR, _YCC_B_CB = _ycc_table(-0.71414), _ycc_table(1.77200)


def _ycbcr_rgba(ycc: np.ndarray) -> np.ndarray:
    """PIL's ``ImagingConvertYCbCr2RGB`` of [..., 3] uint8 YCbCr: Y plus
    each table's entry shifted right by 6, clipped; alpha 255."""
    y = ycc[..., 0].astype(np.int32)
    cb, cr = ycc[..., 1], ycc[..., 2]
    out = np.full(ycc.shape[:-1] + (4,), 255, np.uint8)
    out[..., 0] = np.clip(y + (_YCC_R_CR[cr] >> 6), 0, 255)
    out[..., 1] = np.clip(y + ((_YCC_G_CB[cb] + _YCC_G_CR[cr]) >> 6), 0, 255)
    out[..., 2] = np.clip(y + (_YCC_B_CB[cb] >> 6), 0, 255)
    return out


def _decode_qoi(data: bytes) -> np.ndarray:
    """QoiImagePlugin: ``qoif``, big-endian width and height, a channels
    byte (3: RGB, any other: RGBA; the colorspace byte after it ignored),
    then the ops, decoded by the host library as PIL's QoiDecoder decodes
    them (``utils/codecs.py``, ``csrc/qoi.cpp``)."""
    if len(data) < 14:
        raise _Unreadable("truncated QOI header")
    width, height = struct.unpack_from(">II", data, 4)
    if width == 0 or height == 0:
        raise _Unreadable("empty QOI image")
    _check_size(width, height)
    bands = 3 if data[12] == 3 else 4
    px = codecs.qoi(data[14:], width, height, bands)
    if bands == 4:
        return px
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :3] = px
    return out


# DdsImagePlugin's DDPF flags, and its fourccs and DXGI formats by the
# BcnDecode.c format it decodes them as (0: raw RGBA)
_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000
_DDS_FOURCC = {b"DXT1": 1, b"DXT3": 2, b"DXT5": 3, b"BC4U": 4, b"ATI1": 4,
               b"BC5U": 5, b"ATI2": 5, b"BC5S": 5}
_DXGI = {70: 1, 71: 1, 73: 2, 74: 2, 76: 3, 77: 3, 79: 4, 80: 4, 82: 5,
         83: 5, 84: 5, 95: 6, 96: 6, 97: 7, 98: 7, 99: 7, 27: 0, 28: 0,
         29: 0}
# the DXGI formats PIL decodes as signed: BC5_SNORM and BC6H_SF16
_DXGI_SIGNED = (84, 96)


def _dds_masked(data: bytes, width: int, height: int, bitcount: int,
                masks) -> np.ndarray:
    """DdsRgbDecoder: ``bitcount // 8`` little-endian bytes a pixel (the
    bytes past the file's end zeros: PIL reads them as an empty read),
    each channel ``int((v & mask) >> shift) / (mask >> shift) * 255)`` in
    float64, ``shift`` the mask's trailing zeros; 0 for a zero mask."""
    npix = width * height
    step = bitcount // 8
    values = np.zeros(npix, np.uint64)
    if step and data:
        # pixel i's low 4 bytes (the masks have 32 bits), over the data
        # and 4 zero bytes after it, for the pixels that start in it
        n = min(npix, -(-len(data) // step))
        take = min(step, 4)
        raw = np.frombuffer(data + bytes(4), np.uint8)
        view = np.lib.stride_tricks.as_strided(raw, (n, take), (step, 1))
        values[:n] = (view.astype(np.uint64)
                      << (8 * np.arange(take, dtype=np.uint64))).sum(1)
    out = np.full((height, width, 4), 255, np.uint8)
    for i, mask in enumerate(masks):
        shift = (mask & -mask).bit_length() - 1 if mask else 0
        total = mask >> shift
        channel = np.zeros(npix, np.uint8)
        if total:
            v = ((values & np.uint64(mask)) >> np.uint64(shift)).astype(
                np.float64)
            channel = (v / total * 255).astype(np.uint8)
        out[..., i] = channel.reshape(height, width)
    return out


def _decode_dds(data: bytes) -> np.ndarray:
    """DdsImagePlugin: a 124-byte header, then by its pixel format flags
    (the first of RGB, LUMINANCE, PALETTEINDEXED8 and FOURCC set):
    DdsRgbDecoder's masked pixels (RGB, or RGBA with ALPHAPIXELS), raw L
    (8 bits) or LA (16 with ALPHAPIXELS; the masks ignored), raw indices
    after a 1,024-byte RGBA palette, or DXT1/DXT3/DXT5, BC4, BC5 and BC5S
    blocks (host library, ``csrc/bcn_decode.cpp``) or, after a DX10
    header, those by their DXGI names, BC6H (UF16, SF16: RGB, opaque) and
    BC7 blocks (the sRGB name only sets PIL's ``info["gamma"]``, which
    ``convert`` does not apply) and raw RGBA. PIL reads on from where the
    header ends (its tile offsets are never sought); data past the pixels
    is ignored, and data that ends before the last block is None (PIL:
    "image file is truncated")."""
    if len(data) < 128 or _u32(data, 4) != 124:
        raise _Unreadable("DDS header size")
    _, height, width = struct.unpack_from("<3I", data, 8)
    if width == 0 or height == 0:
        raise _Unreadable("empty DDS image")
    _check_size(width, height)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    pos = 128
    if pfflags & _DDPF_RGB:
        count = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", data, 92)
        return _dds_masked(data[pos:], width, height, bitcount, masks)
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            return _grey_rgba(_rows(data, pos, height, width, width))
        if bitcount != 16 or not pfflags & _DDPF_ALPHAPIXELS:
            raise _Unreadable(f"DDS luminance at {bitcount} bits")
        la = _rows(data, pos, height, 2 * width, 2 * width).reshape(
            height, width, 2)
        out = _grey_rgba(la[..., 0])
        out[..., 3] = la[..., 1]
        return out
    if pfflags & _DDPF_PAL8:
        lut = np.frombuffer(data, np.uint8, 1024, pos).reshape(256, 4)
        return lut[_rows(data, pos + 1024, height, width, width)]
    if not pfflags & _DDPF_FOURCC:
        raise _Unreadable(f"DDS pixel format flags {pfflags}")
    signed = fourcc == b"BC5S"
    if fourcc == b"DX10":
        if len(data) < pos + 4:
            raise _Unreadable("truncated DX10 header")
        dxgi = _u32(data, pos)
        pos += 20
        if dxgi not in _DXGI:
            raise _Unreadable(f"DXGI format {dxgi}")
        n, signed = _DXGI[dxgi], dxgi in _DXGI_SIGNED
        if n == 0:
            return _rows(data, pos, height, 4 * width, 4 * width).reshape(
                height, width, 4)
    elif fourcc in _DDS_FOURCC:
        n = _DDS_FOURCC[fourcc]
    else:
        raise _Unreadable(f"DDS pixel format {fourcc!r}")
    px = codecs.bcn(data[pos:], n, width, height, signed)
    if n == 4:
        return _grey_rgba(px)
    if n in (5, 6):
        px[..., 3] = 255
    return px


def _decode_ico(data: bytes) -> np.ndarray:
    """IcoImagePlugin: the 16-byte directory entries after the 6-byte
    header (``_sniff`` has seen one or more), sorted as ``IcoFile`` sorts
    them: by colour depth (the bit count, else ``ceil(log2)`` of the
    colour count, else 256), then by area, largest first, each sort
    stable; the first is loaded, at its own size where that is not the
    directory's (PIL warns and takes it). Its data is a PNG, read from its
    offset to the file's end (decoded here without its ``tRNS``: PIL takes
    the frame's pixels and palette, not its ``info``), or else a DIB read
    by the DIB reader at its offset, its height halved, converted to RGBA
    and given PIL's alpha: where the entry's bit count is 32, every fourth
    byte of the first ``4 * w * h`` bytes of its pixels, rows bottom-up;
    otherwise the inverted 1-bit AND mask, rows padded to 32 bits and
    bottom-up, read from the end of the entry's resource (its offset plus
    its size), not of the DIB."""
    entries = []
    for i in range(_u16(data, 4)):
        s = data[6 + 16 * i:22 + 16 * i]
        width, height, colours, bits = s[0] or 256, s[1] or 256, s[2], \
            _u16(s, 6)
        depth = bits or (colours != 0 and math.ceil(math.log(colours, 2))) \
            or 256
        entries.append((width * height, depth, bits, _u32(s, 8),
                        _u32(s, 12)))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bits, size, offset = entries[0]
    if data[offset:offset + 8] == _SIGNATURE:
        return _decode_png(data[offset:], transparency=False)
    rgba, at = _bitmap(data, offset, 0, frame="ico")
    h, w = rgba.shape[:2]
    if bits == 32:
        alpha = np.frombuffer(data[at:at + 4 * w * h], np.uint8)
        if alpha.size < 4 * w * h:
            raise _Unreadable("truncated ICO alpha")
        rgba[..., 3] = alpha[3::4].reshape(h, w)[::-1]
        return rgba
    stride = (w + 31) // 32 * 4
    at = offset + size - stride * h
    if at < 0:                    # PIL seeks before the file's start
        raise _Unreadable("ICO AND mask before the file's start")
    mask = _rows(data, at, h, (w + 7) // 8, stride)
    rgba[..., 3] = np.where(_unpack(mask, 1, w)[::-1] != 0, 0, 255)
    return rgba


def _cur_entry(data: bytes) -> "bytes | None":
    """CurImagePlugin._open's pick of the cursor: of the directory entries
    after the 6-byte header, the first, replaced by each later one whose
    width and height bytes are both larger; None where ``_open`` fails in
    a way ``Image.open`` answers by trying the next plugin (a directory or
    entry cut short, no cursor, a bitmap header, masks or size it reads
    past the file's end or finds empty)."""
    m = b""
    for i in range(_u16(data, 4)):
        s = data[6 + 16 * i:22 + 16 * i]
        try:
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
        except IndexError:
            return None
    if len(m) < 16:
        return None
    try:
        (width, height, _, bits, compression, colors, _, masks,
         _) = _bitmap_header(data, _cur_start(data, m))
    except struct.error:
        return None
    except _Unreadable:           # PIL's OSError: no other plugin is tried
        return m
    if width > 0 and height // 2 > 0:
        return m
    # the image's own check of its size comes after _bitmap's OSErrors
    try:
        if (bits not in (1, 4, 8, 16, 24, 32)
                or compression not in (0, 1, 2, 3)
                or bits <= 8 and not 0 < colors <= 65536):
            raise _Unreadable("a bitmap PIL refuses")
        if compression == 3:
            _bitfields(bits, masks)
    except _Unreadable:
        return m
    return None


def _cur_start(data: bytes, m: bytes) -> int:
    """Where PIL reads the cursor's bitmap: at the entry's offset or, for
    an offset of 0 (which ``_bitmap`` takes as no seek), where its reads
    of the directory ended."""
    return _u32(m, 12) or min(6 + 16 * _u16(data, 4), len(data))


def _decode_cur(data: bytes) -> np.ndarray:
    """CurImagePlugin: the cursor :func:`_cur_entry` picks, its bitmap
    read by the BMP reader at its offset, its height halved, with no AND
    mask; a raw 32-bit bitmap is BGRA (its alpha kept) where it starts at
    byte 22 (a one-entry file), else BGRX."""
    start = _cur_start(data, _cur_entry(data))
    return _bitmap(data, start, 0, frame="cur", alpha32=start == 22)[0]


# IcnsFile.SIZES: (width, height, scale) -> its entry types, in the order
# PIL reads them, each a PNG or JPEG 2000 stream ("png"), 24-bit RLE
# ("rle", "it32" after four zero bytes) or an 8-bit mask
_ICNS_SIZES = {
    (512, 512, 2): ((b"ic10", "png"),), (512, 512, 1): ((b"ic09", "png"),),
    (256, 256, 2): ((b"ic14", "png"),), (256, 256, 1): ((b"ic08", "png"),),
    (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "rle"), (b"t8mk", "mask")),
    (64, 64, 1): ((b"icp6", "png"),), (32, 32, 2): ((b"ic12", "png"),),
    (48, 48, 1): ((b"ih32", "rle"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "rle"), (b"l8mk", "mask")),
    (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "rle"), (b"s8mk", "mask"))}
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def _decode_icns(data: bytes) -> np.ndarray:
    """IcnsImagePlugin: the big-endian file length, then blocks of a type
    and a length (the last block of a type kept) up to that length; the
    largest (width, height, scale) of ``IcnsFile.SIZES`` with an entry
    (``bestsize``), each of its entries read in PIL's order (all of them:
    one that fails fails the file):

    - a PNG from the entry's start to the file's end (decoded without its
      ``tRNS``, as for ICO) or a JPEG 2000 stream of the entry's length
      (``utils/jpeg2000.py``, its header's size checked as a
      decompression bomb), as RGBA, which wins;
    - ``read_32``'s 24-bit RGB: uncompressed where the entry's length is
      exactly three planes, else three planes of PackBits-like packets
      (the host library), read on past the entry; ``it32`` after four
      zero bytes;
    - ``read_mk``'s 8-bit mask, the alpha of the RGB (255 without one);

    the size of what wins then checked as PIL's ``size`` setter checks it
    against every size the file holds."""
    if len(data) < 8:
        raise _Unreadable("truncated ICNS header")
    end, pos, blocks = struct.unpack_from(">I", data, 4)[0], 8, {}
    while pos < end:
        if pos + 8 > len(data):
            raise _Unreadable("truncated ICNS block header")
        kind, length = struct.unpack_from(">4sI", data, pos)
        if length == 0:
            raise _Unreadable("invalid ICNS block header")
        blocks[kind] = (pos + 8, length - 8)
        pos += length
    sizes = [size for size, kinds in _ICNS_SIZES.items()
             if any(kind in blocks for kind, _ in kinds)]
    if not sizes:
        raise _Unreadable("no 32-bit ICNS icon")
    best = max(sizes)
    side = best[0] * best[2]
    npix = side * side
    rgba = rgb = alpha = None
    for kind, how in _ICNS_SIZES[best]:
        if kind not in blocks:
            continue
        start, length = blocks[kind]
        # a negative length reads to the file's end, as Python's read(n)
        stop = start + length if length >= 0 else len(data)
        if how == "png":
            rgba = _icns_png_or_jpeg2000(data, start, stop)
        elif how == "mask":
            alpha = np.frombuffer(data[start:start + npix], np.uint8)
            if alpha.size < npix:
                raise _Unreadable("truncated ICNS mask")
        else:
            if kind == b"it32":
                if data[start:start + 4] != bytes(4):
                    raise _Unreadable("it32 entry without its zero bytes")
                start, length = start + 4, length - 4
            if length == 3 * npix:
                rgb = np.frombuffer(data[start:start + length], np.uint8)
                if rgb.size < length:
                    raise _Unreadable("truncated ICNS RGB entry")
                rgb = rgb.reshape(side, side, 3)
            else:
                rgb = np.moveaxis(codecs.icns_rle(data, start, npix), 0, -1
                                  ).reshape(side, side, 3)
    if rgba is None:
        if rgb is None:
            raise _Unreadable("an ICNS size with a mask alone")
        rgba = np.full((side, side, 4), 255, np.uint8)
        rgba[..., :3] = rgb
        if alpha is not None:
            rgba[..., 3] = alpha.reshape(side, side)
    h, w = rgba.shape[:2]
    if not any(s * scale / h == s * scale // w for s, _, scale in sizes):
        raise _Unreadable("not one of the ICNS file's sizes")
    return rgba


def _icns_png_or_jpeg2000(data: bytes, start: int, stop: int) -> np.ndarray:
    """IcnsImagePlugin.read_png_or_jpeg2000: a PNG read from ``start`` to
    the file's end, or a JPEG 2000 stream of ``data[start:stop]`` (PIL
    hands its reader the entry's bytes alone), by their signatures."""
    head = data[start:start + 12]
    if head.startswith(_SIGNATURE):
        return _decode_png(data[start:], transparency=False)
    if head.startswith((b"\xff\x4f\xff\x51", _JP2_SIGNATURE)):
        return _decode_jpeg2000(data[start:stop])
    # anything else fails in PIL, a bare "\r\n\x87\n" too (its ICNS reader
    # hands that to Jpeg2KImageFile, which does not know it)
    raise _Unreadable("unsupported ICNS subimage format")


def _decode_jpeg2000(data: bytes) -> np.ndarray:
    """Image.open's size check on the header's size, then the codestream
    (``utils/jpeg2000.py``)."""
    _check_size(*jpeg2000.header(data))
    return jpeg2000.decode_rgba(data)


def _ftex_opens(d: bytes) -> bool:
    """Whether FtexImagePlugin._open gets past its reads, which ``Image.open``
    answers by trying the next plugin where they run out: the version,
    size and counts, then (a format count of 1; any other fails its
    ``assert``, which ends the open) the format and the offset of the
    mipmap, whose 4-byte length must be in the file (a negative offset
    fails the seek, which ends the open too)."""
    if len(d) < 24:
        return False
    if struct.unpack_from("<i", d, 20)[0] != 1:
        return True
    if len(d) < 32:
        return False
    where = struct.unpack_from("<i", d, 28)[0]
    return where < 0 or where + 4 <= len(d)


def _decode_ftex(data: bytes) -> np.ndarray:
    """FtexImagePlugin: after ``FTEX`` and a version, the signed width and
    height, the mipmap and format counts (the latter 1, PIL's ``assert``),
    the format and the offset of the first mipmap: a signed length (-1
    reads to the end of the file, below -1 fails the read), then its bytes,
    DXT1 blocks (format 0, RGBA: BcnDecode.c's BC1, ``codecs.bcn``) or raw
    RGB (format 1), any other format a ``ValueError``. A size of no pixels
    is None (PIL has closed the file when it finds it, so the next plugin
    fails); data short of the image is None ("image file is truncated"),
    data past it is ignored."""
    width, height = struct.unpack_from("<2i", data, 8)
    if struct.unpack_from("<i", data, 20)[0] != 1:
        raise _Unreadable("FTEX with more than one format")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise _Unreadable("negative FTEX mipmap offset")
    size = struct.unpack_from("<i", data, where)[0]
    if size < -1:
        raise _Unreadable("negative FTEX mipmap length")
    mip = data[where + 4:] if size == -1 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise _Unreadable(f"FTEX texture format {fmt}")
    if width <= 0 or height <= 0:
        raise _Unreadable("empty FTEX image")
    _check_size(width, height)
    if fmt == 0:
        return codecs.bcn(mip, 1, width, height)
    return _set_as_raw(np.frombuffer(mip, np.uint8), width, height, 3)


def _set_as_raw(flat: np.ndarray, width: int, height: int,
                bands: int) -> np.ndarray:
    """[H, W, 4] RGBA of PIL's raw decoder over ``flat`` bytes at ``bands``
    (3: RGB, opaque; 4: RGBA) bytes a pixel: rows of the image's own width
    one after the other, bytes past them ignored; too few bytes are None
    (PIL: "not enough image data", or for FTEX "image file is
    truncated")."""
    need = width * height * bands
    if flat.size < need:
        raise _Unreadable("too little pixel data")
    px = flat.reshape(-1)[:need].reshape(height, width, bands)
    if bands == 4:
        return px.copy()
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :3] = px
    return out


def _blp_read(data: bytes, pos: int, length: int) -> bytes:
    """``_safe_read``: ``length`` bytes from ``pos`` (none for a length of
    0 or less), or None where the file ends first ("Truncated File
    Read")."""
    if length <= 0:
        return b""
    if pos + length > len(data):
        raise _Unreadable("truncated BLP file")
    return data[pos:pos + length]


def _blp_indexed(data: bytes, pos: int, length: int, palette: bytes,
                 bands: int) -> np.ndarray:
    """``_read_bgra``: ``length`` palette indices from ``pos``, each the
    R, G, B (and, ``bands`` 4, A) of its BGRA palette entry."""
    lut = np.frombuffer(palette, np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]]
    idx = np.frombuffer(_blp_read(data, pos, length), np.uint8)
    return lut[idx, :bands]


def _decode_blp(data: bytes) -> np.ndarray:
    """BlpImagePlugin: ``BLP1`` or ``BLP2``, a compression, the alpha flag
    (the mode is RGBA where it is set, else RGB) and the size; BLP2 adds
    the encoding and alpha encoding (its data starts at byte 20), BLP1 the
    encoding and a subtype (at byte 28). There the 16 mipmap offsets and 16
    lengths; PIL reads the first mipmap only:

    - palette images (BLP1 compression 1 encoding 4 or 5, BLP2 compression
      1 encoding 1): the 256 BGRA entries, then ``lengths[0]`` index bytes,
      BLP1's read straight after the palette (its ``offsets[0]`` is not
      sought), BLP2's at ``offsets[0]``; each pixel the entry's R, G, B and,
      with the alpha flag, its A;
    - BLP2 DXT (encoding 2; alpha encoding 0 DXT1, 1 DXT3, 7 DXT5) from
      ``offsets[0]``, after the palette, which BLP2 always reads: PIL's own
      Python decoders, not BcnDecode.c (``codecs.blp_dxt``,
      ``csrc/bcn_decode.cpp`` lists where they differ: widening by a
      shift, DXT1's black transparent only with the alpha flag);
    - BLP1 JPEG (compression 0): a header of the size the 4 bytes after
      the offsets give, then ``offsets[0]`` less where the reads stand
      skipped (nothing where that is 0 or less), then ``lengths[0]``
      bytes; the header and those bytes are one JPEG file, decoded by the
      JPEG decoder here with libjpeg's colour space CMYK for 4 components
      (PIL's jpegmode ``"CMYK"``: an Adobe marker naming YCCK is not
      applied, so such a stream is not decoded as a JPEG file of the same
      bytes is), its RGB taken as BGR (red and blue swapped), opaque.

    Each is then PIL's ``set_as_raw``: the bytes laid out in rows of the
    header's width (a JPEG or a DXT block row of another width runs on
    across rows: DXT3 and DXT5 without the alpha flag are 4 bytes a pixel
    read as 3), too few bytes None ("not enough image data"). Every
    ``BLPFormatError`` (an unknown compression, encoding or alpha
    encoding, BLP2's encoding 3) and every file that ends before a read is
    None, as in the JAX package; a JPEG flavour the JPEG decoder refuses is
    refused."""
    blp1 = data.startswith(b"BLP1")
    compression = struct.unpack_from("<i", data, 4)[0]
    width, height = struct.unpack_from("<II", data, 12)
    if blp1:
        alpha = _u32(data, 8) != 0
        encoding = struct.unpack_from("<i", data, 20)[0]
        alpha_encoding, pos = None, 28
    else:
        encoding, flag, alpha_encoding = struct.unpack_from("<3b", data, 8)
        alpha, pos = flag != 0, 20
    _check_size(width, height)
    bands = 4 if alpha else 3
    header = _blp_read(data, pos, 128)
    offset, length = _u32(header, 0), _u32(header, 64)
    pos += 128
    if blp1 and compression == 0:
        size = _u32(_blp_read(data, pos, 4), 0)
        jpeg_header = _blp_read(data, pos + 4, size)
        pos += 4 + len(jpeg_header)
        pos += len(_blp_read(data, pos, offset - pos))
        rgba = jpeg.decode_rgba(jpeg_header + _blp_read(data, pos, length),
                                cmyk_space=True)
        return _set_as_raw(rgba[..., 2::-1], width, height, 3)
    if blp1 and (compression != 1 or encoding not in (4, 5)):
        raise _Unreadable(f"BLP1 compression {compression} encoding "
                          f"{encoding}")
    palette = _blp_read(data, pos, 1024)
    if blp1:
        return _set_as_raw(_blp_indexed(data, pos + 1024, length, palette,
                                        bands), width, height, bands)
    if compression != 1 or encoding not in (1, 2):
        raise _Unreadable(f"BLP2 compression {compression} encoding "
                          f"{encoding}")
    if encoding == 1:
        return _set_as_raw(_blp_indexed(data, offset, length, palette,
                                        bands), width, height, bands)
    if alpha_encoding not in (0, 1, 7):
        raise _Unreadable(f"BLP2 alpha encoding {alpha_encoding}")
    rows = codecs.blp_dxt(data[offset:], alpha_encoding, alpha, width,
                          height)
    return _set_as_raw(rows, width, height, bands)


# PIL's format name -> the decoder here
_DECODERS = {"PNG": _decode_png, "JPEG": jpeg.decode_rgba,
             "BMP": _decode_bmp, "DIB": _decode_dib, "TGA": _decode_tga,
             "PPM": _decode_pnm, "GIF": _decode_gif, "TIFF": _decode_tiff,
             "PSD": _decode_psd, "WEBP": webp.decode_rgba, "SGI": _decode_sgi,
             "PCX": _decode_pcx, "IM": _decode_im, "QOI": _decode_qoi,
             "DDS": _decode_dds, "ICO": _decode_ico, "CUR": _decode_cur,
             "ICNS": _decode_icns, "JPEG2000": _decode_jpeg2000,
             "BLP": _decode_blp, "FTEX": _decode_ftex, **rasters.DECODERS,
             **bitmaps.DECODERS, **fli_pcd_iptc.DECODERS}
# the formats PIL opens and never decodes, on any host: the stubs of BUFR,
# GRIB and HDF5, which load only through a handler an application
# registers (the JAX package registers none), and MPEG, whose plugin sets
# no tile ("cannot load this image"): None, as in the JAX package
_NO_DECODER = ("BUFR", "GRIB", "HDF5", "MPEG")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pixels(pixels, who: str) -> np.ndarray:
    img = np.asarray(pixels)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"{who}: pixels must be uint8 [H, W] or "
                         f"[H, W, 3], got {img.dtype} {list(img.shape)}")
    return np.ascontiguousarray(img)


def _png_bytes(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = np.zeros((h, 1 + img.size // max(h, 1)), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write uint8 ``pixels``, [H, W] grey (mode ``L``) or [H, W, 3] RGB
    with row 0 = image top, as a PNG file whatever the name: 8 bits,
    non-interlaced, every row under filter 0 (:func:`write_image` writes
    ``.png`` names so)."""
    data = _png_bytes(_pixels(pixels, "write_png"))
    with open(path, "wb") as f:
        f.write(data)


# ---- writers: what PIL 12.1's Image.save writes at its defaults ----------

def _bmp_bytes(img: np.ndarray, file_header: bool = True) -> bytes:
    """BmpImagePlugin._save: a 40-byte info header, 96 dpi as pixels per
    metre, L as 8 bits with a grey palette of (i, i, i, 0) entries, RGB as
    24-bit BGR; rows bottom-up, each padded to 4 bytes."""
    h, w = img.shape[:2]
    grey = img.ndim == 2
    bits, colors = (8, 256) if grey else (24, 0)
    stride = ((w * bits + 7) // 8 + 3) & ~3
    ppm = int(96 * 39.3701 + 0.5)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = (img if grey else img[..., ::-1]).reshape(h, -1)
    palette = bytes(v for i in range(256) for v in (i, i, i, 0)) if grey \
        else b""
    offset = 14 + 40 + colors * 4
    out = b""
    if file_header:
        out = b"BM" + struct.pack("<III", offset + stride * h, 0, offset)
    out += struct.pack("<IIIHHIIIIII", 40, w, h, 1, bits, 0, stride * h,
                       ppm, ppm, colors, colors)
    return out + palette + rows[::-1].tobytes()


def _ppm_bytes(img: np.ndarray) -> bytes:
    """PpmImagePlugin._save: ``P5`` for L and ``P6`` for RGB under every
    PPM name (``.pbm`` and ``.pfm`` too), maxval 255."""
    h, w = img.shape[:2]
    head = b"P5" if img.ndim == 2 else b"P6"
    return head + b"\n%d %d\n255\n" % (w, h) + img.tobytes()


def _tga_bytes(img: np.ndarray) -> bytes:
    """TgaImagePlugin._save: uncompressed (type 3 grey, type 2 BGR),
    bottom-up, no id or colour map, the version 2 footer."""
    h, w = img.shape[:2]
    grey = img.ndim == 2
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 3 if grey else 2, 0, 0, 0,
                         0, 0, w, h, 8 if grey else 24, 0)
    px = img if grey else img[..., ::-1]
    return (header + np.ascontiguousarray(px[::-1]).tobytes()
            + b"\0" * 8 + b"TRUEVISION-XFILE.\0")


def _tiff_bytes(img: np.ndarray) -> bytes:
    """TiffImagePlugin._save without libtiff: little-endian, one IFD at
    offset 8 with its tags in ascending order, the values longer than 4
    bytes after it (for RGB, BitsPerSample's), then one uncompressed
    strip."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    ntags = 9 if spp == 1 else 10
    aux_at = 8 + 2 + 12 * ntags + 4
    aux = struct.pack("<3H", 8, 8, 8) if spp > 1 else b""
    pixels_at = aux_at + len(aux)
    short, long_ = 3, 4
    tags = [(256, long_, w), (257, long_, h),
            (258, short, 8) if spp == 1 else (258, short, 3, aux_at),
            (259, short, 1), (262, short, 1 if spp == 1 else 2),
            (273, long_, pixels_at)] + (
        [(277, short, spp)] if spp > 1 else []) + [
        (278, long_, h), (279, long_, w * spp * h), (284, short, 1)]
    entries = b""
    for tag, kind, *rest in tags:
        if len(rest) == 2:        # count 3, value at an offset
            entries += struct.pack("<HHII", tag, kind, rest[0], rest[1])
        else:
            value = struct.pack("<H" if kind == short else "<I", rest[0])
            entries += struct.pack("<HHI", tag, kind, 1) + value.ljust(4,
                                                                       b"\0")
    return (b"II*\0" + struct.pack("<IH", 8, ntags) + entries + b"\0" * 4
            + aux + img.tobytes())


def _im_bytes(img: np.ndarray, path: str) -> bytes:
    """ImImagePlugin._save: a text header naming the file (its basename,
    the stem cut to leave the line 100 characters, ASCII or PIL's
    ``UnicodeEncodeError``), zeros up to byte 511 and ``0x1A``, then the
    rows bottom-up, each RGB row as its R, G and B runs (``RGB;L``)."""
    h, w = img.shape[:2]
    name, ext = os.path.splitext(os.path.basename(path))
    name = name[:92 - len(ext)] + ext
    head = (f"Image type: {'Greyscale' if img.ndim == 2 else 'RGB'} "
            "image\r\n".encode("ascii")
            + f"Name: {name}\r\n".encode("ascii")
            + f"Image size (x*y): {w}*{h}\r\n".encode("ascii")
            + b"File size (no of images): 1\r\n")
    head += b"\0" * (511 - len(head)) + b"\032"
    rows = img[::-1] if img.ndim == 2 else img[::-1].transpose(0, 2, 1)
    return head + np.ascontiguousarray(rows).tobytes()


def _sgi_bytes(img: np.ndarray, path: str) -> bytes:
    """SgiImagePlugin._save: the 512-byte header (magic 474, no RLE, one
    byte a sample, the stem of the file's basename in ASCII with the rest
    dropped, cut to 79 bytes), then each channel's rows bottom-up."""
    h, w = img.shape[:2]
    z = 1 if img.ndim == 2 else 3
    dimension = (1 if h == 1 else 2) if z == 1 else 3
    name = os.path.splitext(os.path.basename(path))[0]
    if isinstance(name, str):
        name = name.encode("ascii", "ignore")
    head = (struct.pack(">hBBHHHHll4s79ss", 474, 0, 1, dimension, w, h, z,
                        0, 255, b"", name, b"")
            + struct.pack(">l404s", 0, b""))
    planes = img[::-1] if z == 1 else np.moveaxis(img[::-1], -1, 0)
    return head + np.ascontiguousarray(planes).tobytes()


def _pcx_bytes(img: np.ndarray) -> bytes:
    """PcxImagePlugin._save: version 5, 8 bits, one plane (L, then PIL's
    grey palette after ``0x0C``) or three (RGB); each row's planes run-
    length coded as PcxEncode.c codes them (runs of up to 63, a single
    byte under 0xC0 as itself, else ``0xC0 | count`` and the byte), each
    followed by a zero byte where the width is odd. An RGB image one pixel
    wide loses its blue plane, as in PcxEncode.c (its loop over the planes
    ends before the last one-byte plane is written)."""
    h, w = img.shape[:2]
    planes = 1 if img.ndim == 2 else 3
    stride = w + w % 2
    header = struct.pack("<BBBBHHHHHH24s24sBBHHHH54s", 10, 5, 1, 8, 0, 0,
                         w - 1, h - 1, 100, 100, b"", b"\xff" * 24, 0,
                         planes, stride, 1, w, h, b"")
    lines = img[:, None] if planes == 1 else img.transpose(0, 2, 1)
    if planes == 3 and w == 1:
        lines = lines[:, :2]
    lines = np.ascontiguousarray(lines).reshape(-1, w)
    flat = lines.ravel()
    start = np.ones(flat.size, bool)
    start[1:] = flat[1:] != flat[:-1]
    start[::w] = True                 # a line starts a run
    pos = np.flatnonzero(start)
    run = np.diff(np.append(pos, flat.size))
    chunks = (run + 62) // 63         # runs of up to 63
    length = np.full(chunks.sum(), 63, np.int64)
    length[np.cumsum(chunks) - 1] = run - 63 * (chunks - 1)
    value = np.repeat(flat[pos], chunks)
    line = np.repeat(pos // w, chunks)
    single = (length == 1) & (value < 0xC0)
    size = np.where(single, 1, 2)
    at = np.cumsum(size) - size + line * (stride - w)
    body = np.zeros(int(size.sum()) + len(lines) * (stride - w), np.uint8)
    body[at] = np.where(single, value, 0xC0 | length)
    body[at[~single] + 1] = value[~single]
    grey = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return header + body.tobytes() + (grey if planes == 1 else b"")


def _qoi_bytes(img: np.ndarray) -> bytes:
    """QoiImagePlugin._save for RGB (L raises before this): ``qoif``, the
    big-endian size, 3 channels, colorspace 1 (PIL writes 0 only when
    asked for ``colorspace="sRGB"``), then PIL's QoiEncoder ops (host
    library, ``csrc/qoi.cpp``)."""
    h, w = img.shape[:2]
    if img.size == 0:             # what PIL raises on the way
        raise ValueError("Size cannot be negative")
    return (b"qoif" + struct.pack(">II", w, h) + bytes((3, 1))
            + codecs.qoi_encode(img))


def _dds_bytes(img: np.ndarray) -> bytes:
    """DdsImagePlugin._save without a ``pixel_format``: the 128-byte
    header (flags CAPS, HEIGHT, WIDTH, PIXELFORMAT and PITCH, the pitch
    ``(w * bits + 7) // 8``), then the rows top-down: L as LUMINANCE at 8
    bits (the masks ``0xFF000000`` three times, as PIL writes them), RGB
    as RGB at 24 bits (masks ``0xFF0000 0xFF00 0xFF``) stored as BGR."""
    h, w = img.shape[:2]
    if img.size == 0:
        raise SystemError("tile cannot extend outside image")
    grey = img.ndim == 2
    bits = 8 if grey else 24
    flags, masks = ((_DDPF_LUMINANCE, (0xFF000000,) * 3) if grey else
                    (_DDPF_RGB, (0xFF0000, 0xFF00, 0xFF)))
    caps_height_width_pitch_pixelformat = 0x100F
    head = (b"DDS " + struct.pack("<7I", 124,
                                  caps_height_width_pitch_pixelformat, h, w,
                                  (w * bits + 7) // 8, 0, 0)
            + bytes(44) + struct.pack("<4I", 32, flags, 0, bits)
            + struct.pack("<4I", *masks, 0)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + (img if grey else img[..., ::-1]).tobytes()


def _eps_bytes(img: np.ndarray) -> bytes:
    """EpsImagePlugin._save (``eps=1`` under both names): the EPS comments
    (the ``%%%%`` lines formatted with ``%``, so one ``%`` of each pair
    goes, as in PIL), PostScript's ``image`` (L) or ``false 3
    colorimage`` (RGB) header, the samples as EpsEncode.c writes them
    (lower-case hex, a newline after every 39 bytes but the last, the
    count running on across rows), then ``%%%%EndBinary`` (a literal PIL
    does not format) and ``grestore end``."""
    h, w = img.shape[:2]
    if img.size == 0:
        raise SystemError("tile cannot extend outside image")
    bands, operator = (1, b"image") if img.ndim == 2 else (
        3, b"false 3 colorimage")
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n"
            b"%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h)
            + b'%d %d 0 1 1 "%s"\n' % (8, bands, operator)
            + b"gsave\n10 dict begin\n"
            + b"/buf %d string def\n" % (w * bands)
            + b"%d %d scale\n" % (w, h) + b"%d %d 8\n" % (w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n"
            + operator + b"\n")
    text = img.tobytes().hex().encode("ascii")
    body = b"\n".join(text[i:i + 78] for i in range(0, len(text), 78))
    return head + body + b"\n%%%%EndBinary\n" + b"grestore end\n"


def _pdf_string(text) -> bytes:
    """PdfParser.pdf_repr of a str (``encode_text``: UTF-16BE after a BOM,
    raising ``UnicodeEncodeError`` as PIL does for a lone surrogate) as a
    literal string, with PIL's escapes of backslash and parentheses."""
    raw = b"\xfe\xff" + text.encode("utf_16_be")
    raw = raw.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(
        b")", b"\\)")
    return b"(" + raw + b")"


def _pdf_bytes(img: np.ndarray, path: str) -> bytes:
    """PdfImagePlugin._save at its defaults: ``%PDF-1.4`` and PIL's
    comment, then PdfParser's objects in PIL's order: the catalog (4), the
    pages (5), the image XObject (1: the JPEG file :func:`jpeg.encode`
    writes, which PIL embeds for L and RGB, as ``/DCTDecode`` in
    ``/DeviceGray`` or ``/DeviceRGB``), the page (2: the procedure set
    ``/ImageB`` or ``/ImageC``, a 72 dpi MediaBox in Python's float
    reprs), its contents (3) and the info dictionary (6: the file's stem
    as the title, the creation and modification dates from two calls of
    ``time.gmtime()`` where PIL makes them), the cross-reference table
    and the trailer."""
    h, w = img.shape[:2]
    title = os.path.splitext(os.path.basename(path))[0]
    created, modified = time.gmtime(), time.gmtime()
    stream = jpeg.encode(img)
    grey = img.ndim == 2
    width, height = w * 72.0 / 72.0, h * 72.0 / 72.0
    contents = b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (width, height)
    info = b"<<\n/Title " + _pdf_string(title)
    for key, when in ((b"CreationDate", created), (b"ModDate", modified)):
        info += b"\n/%s (D:%s)" % (key, time.strftime(
            "%Y%m%d%H%M%SZ", when).encode("us-ascii"))
    objects = (
        (4, b"<<\n/Type /Catalog\n/Pages 5 0 R\n>>"),
        (5, b"<<\n/Type /Pages\n/Count 1\n/Kids [ 2 0 R ]\n>>"),
        (1, b"<<\n/Type /XObject\n/Subtype /Image\n/Width %d\n/Height %d"
            b"\n/Filter /DCTDecode\n/BitsPerComponent 8\n/ColorSpace "
            b"/Device%s\n/Length %d\n>>stream\n" % (
                w, h, b"Gray" if grey else b"RGB", len(stream))
         + stream + b"\nendstream\n"),
        (2, b"<<\n/Resources <<\n/ProcSet [ /PDF /Image%s ]\n/XObject <<"
            b"\n/image 1 0 R\n>>\n>>\n/MediaBox [ 0 0 %s %s ]\n/Contents "
            b"3 0 R\n/Type /Page\n/Parent 5 0 R\n>>" % (
                b"B" if grey else b"C", repr(width).encode(),
                repr(height).encode())),
        (3, b"<<\n/Length %d\n>>stream\n" % len(contents) + contents
         + b"\nendstream\n"),
        (6, info + b"\n>>"))
    out = b"%PDF-1.4\n% created by Pillow PDF driver\n"
    offsets = {}
    for number, body in objects:
        offsets[number] = len(out)
        out += b"%d 0 obj" % number + body + b"endobj\n"
    xref = len(out)
    out += b"xref\n0 7\n0000000000 65536 f \n" + b"".join(
        b"%010d 00000 n \n" % offsets[n] for n in range(1, 7))
    return out + (b"trailer\n<<\n/Root 4 0 R\n/Size 7\n/Info 6 0 R\n>>"
                  b"\nstartxref\n%d\n%%%%EOF" % xref)


# IcoImagePlugin._save's default sizes, and IcnsImagePlugin._save's entry
# types with the side of the square each holds, in PIL's order
_ICO_SIDES = (16, 24, 32, 48, 64, 128, 256)
_ICNS_ENTRIES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512),
                 (b"ic10", 1024), (b"ic11", 32), (b"ic12", 64),
                 (b"ic13", 256), (b"ic14", 512))


def _ico_bytes(img: np.ndarray) -> bytes:
    """IcoImagePlugin._save at its defaults (``bitmap_format="png"``): a
    frame for each default square that fits the image (none under 16
    pixels a side: a 6-byte file), each PIL's LANCZOS thumbnail into it
    (``reducing_gap=None``: :mod:`resample`), then the 6-byte header, a
    16-byte entry a frame (width and height, 0 for 256; 0 colours, 0
    planes, 32 bits; the PNG's length and offset) and each frame's PNG
    (:func:`_png_bytes`: PIL's pixels, not PIL's deflate stream)."""
    h, w = img.shape[:2]
    pngs = [_png_bytes(resample.thumbnail(img, (side, side),
                                          resample.LANCZOS))
            for side in _ICO_SIDES if side <= w and side <= h]
    out = b"\0\0\1\0" + struct.pack("<H", len(pngs))
    offset = len(out) + 16 * len(pngs)
    for png in pngs:
        fw, fh = struct.unpack_from(">II", png, 16)
        out += struct.pack("<BBBBHHII", fw % 256, fh % 256, 0, 0, 0, 32,
                           len(png), offset)
        offset += len(png)
    return out + b"".join(pngs)


def _icns_bytes(img: np.ndarray) -> bytes:
    """IcnsImagePlugin._save: PIL's BICUBIC resize of the image to each
    square (32 to 1024, upscaling too: :mod:`resample`) as a PNG
    (:func:`_png_bytes`), then ``icns`` and the file's length, the ``TOC
    `` block listing each entry's type and length, and the entries in
    PIL's order (``ic08`` and ``ic13``, ``ic09`` and ``ic14`` the same
    PNG), lengths big-endian and counting their 8-byte headers."""
    pngs = {side: _png_bytes(resample.resize(img, (side, side),
                                             resample.BICUBIC))
            for side in sorted({side for _, side in _ICNS_ENTRIES})}
    entries = [(kind, pngs[side]) for kind, side in _ICNS_ENTRIES]
    toc = b"TOC " + struct.pack(">i", 8 + 8 * len(entries)) + b"".join(
        kind + struct.pack(">i", 8 + len(png)) for kind, png in entries)
    body = b"".join(kind + struct.pack(">i", 8 + len(png)) + png
                    for kind, png in entries)
    return b"icns" + struct.pack(">i", 8 + len(toc) + len(body)) + toc + body


_WRITERS = {
    "PNG": _png_bytes, "JPEG": jpeg.encode,
    "BMP": _bmp_bytes, "DIB": lambda img: _bmp_bytes(img, False),
    "TIFF": _tiff_bytes, "PPM": _ppm_bytes, "TGA": _tga_bytes,
    "GIF": gif.encode, "PCX": _pcx_bytes, "WEBP": webp.encode,
    "QOI": _qoi_bytes, "DDS": _dds_bytes, "EPS": _eps_bytes,
    # a single frame: PIL's MpoImagePlugin._save is JPEG's _save
    "MPO": jpeg.encode, "ICO": _ico_bytes, "ICNS": _icns_bytes}
# the writers that need the file's name (IM, SGI and PDF write it into
# the file)
_NAMED_WRITERS = {
    "IM": _im_bytes, "SGI": _sgi_bytes, "PDF": _pdf_bytes,
    # Jpeg2KImagePlugin._save: a codestream where the name's bytes end in
    # ".j2k" (case-sensitive, unlike the lower-cased extension that picks
    # the format), else a JP2 file
    "JPEG2000": lambda img, path: jpeg2000.encode(
        img, "j2k" if path.encode().endswith(b".j2k") else "jp2")}

# PIL 12.1's Image.registered_extensions(), by format: the format
# Image.save picks from a file name's lower-cased extension
_PIL_FORMATS = {
    "AVIF": ".avif .avifs", "BLP": ".blp", "BMP": ".bmp", "BUFR": ".bufr",
    "CUR": ".cur", "DCX": ".dcx", "DDS": ".dds", "DIB": ".dib",
    "EPS": ".eps .ps", "FITS": ".fit .fits", "FLI": ".flc .fli",
    "FTEX": ".ftc .ftu", "GBR": ".gbr", "GIF": ".gif", "GRIB": ".grib",
    "HDF5": ".h5 .hdf", "ICNS": ".icns", "ICO": ".ico", "IM": ".im",
    "IPTC": ".iim", "JPEG": ".jfif .jpe .jpeg .jpg",
    "JPEG2000": ".j2c .j2k .jp2 .jpc .jpf .jpx", "MPEG": ".mpeg .mpg",
    "MPO": ".mpo", "MSP": ".msp", "PALM": ".palm", "PCD": ".pcd",
    "PCX": ".pcx", "PDF": ".pdf", "PIXAR": ".pxr", "PNG": ".apng .png",
    "PPM": ".pbm .pfm .pgm .pnm .ppm", "PSD": ".psd", "QOI": ".qoi",
    "SGI": ".bw .rgb .rgba .sgi", "SUN": ".ras",
    "TGA": ".icb .tga .vda .vst", "TIFF": ".tif .tiff", "WEBP": ".webp",
    "WMF": ".emf .wmf", "XBM": ".xbm", "XPM": ".xpm"}
EXTENSIONS = {ext: fmt for fmt, exts in _PIL_FORMATS.items()
              for ext in exts.split()}

# what PIL 12.1's Image.save raises for the 27 extensions it cannot write
# as L or RGB: no save handler (KeyError), a handler of a plugin that
# needs one installed (OSError), or a handler that refuses the mode
_PIL_CANNOT_SAVE = {
    **{fmt: (KeyError, fmt) for fmt in (
        "CUR", "DCX", "FITS", "FLI", "FTEX", "GBR", "IPTC", "MPEG", "PCD",
        "PIXAR", "PSD", "SUN", "XPM")},
    **{fmt: (OSError, f"{fmt} save handler not installed")
       for fmt in ("BUFR", "GRIB", "HDF5", "WMF")},
    **{fmt: (OSError, "cannot write mode {mode} as " + name)
       for fmt, name in (("MSP", "MSP"), ("PALM", "Palm"), ("XBM", "XBM"))},
    "BLP": (ValueError, "Unsupported BLP image mode"),
}


def write_image(path, pixels: np.ndarray) -> None:
    """Write uint8 ``pixels`` ([H, W] grey, PIL's mode ``L``, or [H, W, 3]
    RGB; row 0 = image top) in the format the file name's extension names,
    as the JAX package's ``PIL.Image.save(path)`` does:

    - ``.png``/``.apng``: :func:`write_png` (the decoded pixels equal
      PIL's file; its bytes are not held);
    - JPEG, BMP, DIB, TIFF, PPM, TGA, GIF, IM, SGI, PCX, WebP, QOI, DDS,
      EPS (``.eps``, ``.ps``), MPO, PDF and JPEG 2000 names: PIL's file at
      its defaults, byte for byte (JPEG and MPO: quality 75, 4:2:0, the host
      library's encoder; GIF: the host library's median cut and LZW;
      WebP: the host library's lossy VP8 encoder at quality 80, a side
      over 16,383 pixels raising PIL's ``ValueError``; QOI: RGB only, L
      raising PIL's ``ValueError``; IM, SGI and PDF write the file's name
      into the file, as PIL does; PDF embeds the JPEG and two readings of
      ``time.gmtime()``; JPEG 2000: OpenJPEG's lossless codestream, bare
      for a name ending in ``.j2k``, else in a JP2 file, the host
      library's encoder, an empty image raising PIL's ``SystemError``);
    - ``.ico`` and ``.icns``: PIL's directory, and frames whose pixels
      and mode are PIL's (PIL's LANCZOS thumbnails and BICUBIC resizes,
      the host library's resampler), each frame a PNG as
      :func:`write_png` writes it;
    - an extension PIL registers but cannot save as L or RGB: PIL's
      exception (``KeyError`` without a save handler, ``OSError`` or
      ``ValueError`` where the handler refuses), writing nothing;
    - either of the 2 other extensions PIL registers (AVIF's):
      ``NotImplementedError`` naming the path and the format (never PNG
      bytes under another name);
    - an extension PIL does not know, or none: ``ValueError("unknown file
      extension: ...")``, as PIL raises.
    """
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in EXTENSIONS:
        raise ValueError(f"unknown file extension: {ext}")
    fmt = EXTENSIONS[ext]
    img = _pixels(pixels, "write_image")
    mode = "L" if img.ndim == 2 else "RGB"
    if fmt in _PIL_CANNOT_SAVE:
        kind, what = _PIL_CANNOT_SAVE[fmt]
        raise kind(what.format(mode=mode))
    if fmt == "QOI" and mode == "L":
        raise ValueError("Unsupported QOI image mode")
    if fmt in _NAMED_WRITERS:
        data = _NAMED_WRITERS[fmt](img, path)
    elif fmt in _WRITERS:
        data = _WRITERS[fmt](img)
    else:
        raise NotImplementedError(
            f"{path}: writing {fmt} is not done by the PyTorch port (PNG, "
            "JPEG, BMP, DIB, TIFF, PPM, TGA, GIF, IM, SGI, PCX, WebP, QOI, "
            "DDS, EPS, MPO, PDF, ICO, ICNS and JPEG 2000 are; ROADMAP Queue "
            "1 item 11)")
    with open(path, "wb") as f:
        f.write(data)


def sample_nearest(img: "np.ndarray | None", u: float, v: float) -> np.ndarray:
    """Host-side ``tex2D`` for tests and tools (the device path is
    ``ops/texturing.py``)."""
    if img is None:
        return np.zeros(4, np.float32)
    if u > 1.0 or u < 0.0 or v > 1.0 or v < 0.0:
        return np.zeros(4, np.float32)
    h, w = img.shape[:2]
    x = min(int(w * u), w - 1)
    y = min(int(h * v), h - 1)
    return img[y, x]
